// Copied from tdr/native/countdocs.cc.
// tdr native (doc, term) counting: the encode pipeline's numpy tail
// (np.repeat -> pack -> np.unique -> bincounts) re-reads the 27M-token en
// stream ~30 times through 64-bit temporaries; on slow-memory hosts that
// measured 56 s of the 170 s full-fidelity index build (round-4 profiling,
// /tmp/profile_en.py: repeat 6.3 + bincount 6.8 + pack 13.8 + unique 20.3 +
// split/df 8.6).  This is a single pass over the int32 stem stream with a
// per-doc open-addressing counter, emitting the COO already in
// (doc asc, term asc) order — byte-identical to np.unique(packed) — plus
// doc_lens and df in the same pass.
//
// Bigram augmentation (fr/de/es/it "best" pipeline) matches
// tdr.text.fast.fast_encode_corpus exactly: joined 2-grams of consecutive
// same-doc stems, pair key = (left << 32) | right, and pair ids assigned in
// SORTED-key order (np.unique(pair_key) order) starting at n_unigram.
//
// C ABI (ctypes): tdr_count_docs / tdr_free_count.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// open-addressing int64->int32 counter, reused across docs (capacity is
// sized for the largest doc once; clearing marks via an epoch stamp)
struct DocCounter {
  std::vector<int64_t> keys;
  std::vector<int32_t> counts;
  std::vector<uint32_t> stamp;
  uint32_t epoch = 0;
  size_t mask = 0;

  void reserve(size_t n_items) {
    size_t cap = 16;
    while (cap < n_items * 2) cap <<= 1;
    if (cap > keys.size()) {
      keys.assign(cap, 0);
      counts.assign(cap, 0);
      stamp.assign(cap, 0);
      mask = cap - 1;
      epoch = 0;
    }
  }

  inline void bump() { ++epoch; }

  inline void add(int64_t key) {
    size_t h = (size_t)(((uint64_t)key) * 0x9E3779B97F4A7C15ULL) & mask;
    while (true) {
      if (stamp[h] != epoch) {
        stamp[h] = epoch;
        keys[h] = key;
        counts[h] = 1;
        return;
      }
      if (keys[h] == key) {
        ++counts[h];
        return;
      }
      h = (h + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

struct TdrCountResult {
  int32_t* doc_ids;    // (nnz)
  int32_t* term_ids;   // (nnz) — stems, then bigram ids >= n_unigram
  float* tfs;          // (nnz)
  int32_t* doc_lens;   // (n_docs) tokens incl. bigrams (pre-min_df)
  int32_t* df;         // (vocab_size)
  int64_t* pair_keys;  // (n_pairs) sorted (left<<32)|right keys
  int64_t nnz;
  int64_t n_docs;
  int64_t n_pairs;
  int32_t vocab_size;  // n_unigram + n_pairs
};

TdrCountResult* tdr_count_docs(const int32_t* stream,
                               const int64_t* doc_offsets, int64_t n_docs,
                               int32_t n_unigram, int32_t emit_bigrams) {
  // ---- pass 1 (bigrams only): unique pair keys -> sorted -> dense ids ---
  std::vector<int64_t> pair_keys;
  std::unordered_map<int64_t, int32_t> pair_id;
  if (emit_bigrams) {
    std::vector<int64_t> uniq;
    uniq.reserve(1 << 16);
    std::unordered_map<int64_t, char> seen;
    seen.reserve(1 << 16);
    for (int64_t d = 0; d < n_docs; ++d) {
      for (int64_t i = doc_offsets[d]; i + 1 < doc_offsets[d + 1]; ++i) {
        int64_t key = ((int64_t)stream[i] << 32) | (uint32_t)stream[i + 1];
        if (seen.emplace(key, 1).second) uniq.push_back(key);
      }
    }
    std::sort(uniq.begin(), uniq.end());
    pair_keys = std::move(uniq);
    pair_id.reserve(pair_keys.size() * 2);
    for (size_t i = 0; i < pair_keys.size(); ++i)
      pair_id.emplace(pair_keys[i], (int32_t)(n_unigram + (int64_t)i));
  }
  const int32_t vocab_size = n_unigram + (int32_t)pair_keys.size();

  // ---- pass 2: per-doc counting, emitted (doc asc, term asc) -----------
  std::vector<int32_t> out_doc, out_term;
  std::vector<float> out_tf;
  int64_t total_tokens = doc_offsets[n_docs];
  out_doc.reserve(total_tokens / 2 + 16);
  out_term.reserve(total_tokens / 2 + 16);
  out_tf.reserve(total_tokens / 2 + 16);

  int32_t* doc_lens = new int32_t[n_docs ? n_docs : 1]();
  int32_t* df = new int32_t[vocab_size ? vocab_size : 1]();

  DocCounter counter;
  std::vector<int32_t> terms_sorted;
  for (int64_t d = 0; d < n_docs; ++d) {
    int64_t lo = doc_offsets[d], hi = doc_offsets[d + 1];
    int64_t len = hi - lo;
    int64_t n_items = emit_bigrams ? (2 * len) : len;
    if (!n_items) continue;
    counter.reserve((size_t)n_items);
    counter.bump();
    for (int64_t i = lo; i < hi; ++i) counter.add(stream[i]);
    if (emit_bigrams) {
      for (int64_t i = lo; i + 1 < hi; ++i) {
        int64_t key = ((int64_t)stream[i] << 32) | (uint32_t)stream[i + 1];
        counter.add((int64_t)pair_id.find(key)->second);
      }
    }
    doc_lens[d] =
        (int32_t)(len + (emit_bigrams && len > 1 ? len - 1 : 0));
    terms_sorted.clear();
    for (size_t h = 0; h <= counter.mask; ++h)
      if (counter.stamp[h] == counter.epoch)
        terms_sorted.push_back((int32_t)counter.keys[h]);
    std::sort(terms_sorted.begin(), terms_sorted.end());
    for (int32_t t : terms_sorted) {
      // re-probe for the count (cheaper than carrying (key, count) pairs
      // through the sort at typical doc sizes)
      size_t h = (size_t)(((uint64_t)(int64_t)t) * 0x9E3779B97F4A7C15ULL) &
                 counter.mask;
      while (counter.keys[h] != t || counter.stamp[h] != counter.epoch)
        h = (h + 1) & counter.mask;
      out_doc.push_back((int32_t)d);
      out_term.push_back(t);
      out_tf.push_back((float)counter.counts[h]);
      ++df[t];
    }
  }

  TdrCountResult* res = new TdrCountResult();
  res->nnz = (int64_t)out_doc.size();
  res->n_docs = n_docs;
  res->n_pairs = (int64_t)pair_keys.size();
  res->vocab_size = vocab_size;
  size_t nnz = out_doc.size() ? out_doc.size() : 1;
  res->doc_ids = new int32_t[nnz];
  res->term_ids = new int32_t[nnz];
  res->tfs = new float[nnz];
  memcpy(res->doc_ids, out_doc.data(), out_doc.size() * sizeof(int32_t));
  memcpy(res->term_ids, out_term.data(), out_term.size() * sizeof(int32_t));
  memcpy(res->tfs, out_tf.data(), out_tf.size() * sizeof(float));
  res->doc_lens = doc_lens;
  res->df = df;
  res->pair_keys = new int64_t[pair_keys.size() ? pair_keys.size() : 1];
  memcpy(res->pair_keys, pair_keys.data(),
         pair_keys.size() * sizeof(int64_t));
  return res;
}

void tdr_free_count(TdrCountResult* res) {
  if (!res) return;
  delete[] res->doc_ids;
  delete[] res->term_ids;
  delete[] res->tfs;
  delete[] res->doc_lens;
  delete[] res->df;
  delete[] res->pair_keys;
  delete res;
}

}  // extern "C"
