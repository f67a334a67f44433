// Tail-posting compaction for the BM25 tail terms, written for Hopper (sm_90a).
//
// Replaces the TPU kernel `tail_compact_pallas` (tdr/ops/pallas_tail.py,
// body `_make_kernel`).  For each query, up to MT tail terms (already
// compacted and scanned in torch: start, length, compacted offset and query
// weight per term) each own one contiguous CSR postings segment.  The kernel
// writes a row of width W: every lane first holds (sentinel, -1.0), then
// term t's segment lands at lanes [off_t, off_t + len_t) as
// (postings_doc[i], postings_w[i] * qw_t).
//
// What bounds it on this card: bytes, and at the main path's size not even
// those.  At Q = 256, W = 2048 it writes 4.2 MB and reads at most
// Q * MT * tail_pmax * 8 bytes (0.5 MB): about 1.4 us at 3.35 TB/s, far
// below one launch.  So the design is the simplest one that is exact.
// One block per query; the fill and each segment copy are coalesced
// (neighbouring threads on neighbouring addresses).  The TPU kernel's
// aligned DMA window and roll placement are not needed: a thread reads
// exactly [start, start + len).  Terms are walked IN ORDER with a barrier
// between them, so where clamped offsets overlap (an overflowed query) a
// later term overwrites an earlier one exactly as the Pallas kernel does:
// the output is bit for bit the TPU kernel's, overflowed rows included.

#include <cuda_runtime.h>

namespace {

__global__ void tail_compact_kernel(
    const int* __restrict__ postings_doc, const float* __restrict__ postings_w,
    const int* __restrict__ starts, const int* __restrict__ lens,
    const int* __restrict__ offs, const float* __restrict__ qw,
    int* __restrict__ docs_out, float* __restrict__ vals_out,
    int MT, int W, int sentinel) {
  const int q = blockIdx.x;
  int* drow = docs_out + (size_t)q * W;
  float* vrow = vals_out + (size_t)q * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    drow[i] = sentinel;
    vrow[i] = -1.0f;
  }
  __syncthreads();
  for (int t = 0; t < MT; ++t) {
    const int len = lens[q * MT + t];
    if (len <= 0) continue;              // uniform across the block
    const int start = starts[q * MT + t];
    const int off = offs[q * MT + t];
    const float w = qw[q * MT + t];
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      if (off + i < W) {
        drow[off + i] = postings_doc[start + i];
        vrow[off + i] = postings_w[start + i] * w;
      }
    }
    __syncthreads();                     // term t lands before term t + 1
  }
}

}  // namespace

extern "C" int tdr_tail_compact(
    const int* postings_doc, const float* postings_w, const int* starts,
    const int* lens, const int* offs, const float* qw, int* docs_out,
    float* vals_out, int Q, int MT, int W, int sentinel, void* stream) {
  if (Q > 0) {
    tail_compact_kernel<<<Q, 256, 0, (cudaStream_t)stream>>>(
        postings_doc, postings_w, starts, lens, offs, qw, docs_out, vals_out,
        MT, W, sentinel);
  }
  return (int)cudaGetLastError();
}
