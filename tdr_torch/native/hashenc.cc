// Copied from tdr/native/hashenc.cc.
// tdr native feature-hash encoder for the dense dual encoder.
//
// Replicates tdr/text/hash_tokenizer.py (encode_text/encode_batch) in C++:
// `\w+` word scan over the lowercased text, FNV-1a word buckets, plus up to
// `ngrams_per_word` character-n-gram buckets per word.  The corpus-wide
// sentence embedding pass (team_run1.py:225-239 semantics; 600k+ sentences
// at reference scale) is host-hashing bound in pure Python — per-character
// interpreter FNV dominates the device forward by an order of magnitude —
// so this path hashes the whole batch in one native call, threaded over
// rows, writing directly into the caller's (B, L) id/mask buffers.
//
// Parity contract: identical ids to the Python encoder for text in the
// scripts lower_cp/is_hash_word_cp cover (Latin + Latin-1/Ext-A, Greek,
// Cyrillic, Arabic, Hangul, CJK, kana — everything the 7-language corpus
// produces).  Python's str.lower()/`\w` know the full Unicode tables, so
// exotic scripts outside that set may bucket differently; both paths remain
// self-consistent, and the parity test (tests/test_native.py) pins the
// covered set on real corpus sentences.

#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "utf8.h"

namespace {

using tdrnat::decode_utf8;
using tdrnat::encode_utf8;
using tdrnat::is_cased_cp;
using tdrnat::lower_cp;

constexpr uint64_t kFnvOffset = 14695981039346656037ull;
constexpr uint64_t kFnvPrime = 1099511628211ull;
constexpr int32_t kClsId = 1;
constexpr int32_t kReserved = 2;

inline uint64_t fnv1a(const char* s, size_t n, uint64_t h = kFnvOffset) {
  for (size_t i = 0; i < n; ++i)
    h = (h ^ (unsigned char)s[i]) * kFnvPrime;
  return h;
}

// Python `\w` approximation: alphanumerics (str.isalnum()) plus underscore.
// Mirrors tokenizer.cc's is_word_cp but adds '_' (the hash path scans RAW
// text — no punctuation-to-space translation happens first) and the
// Latin-1 letter singletons ª µ º that sit below 0xC0.
inline bool is_hash_word_cp(uint32_t cp) {
  if (cp < 0x80)
    return (cp >= '0' && cp <= '9') || (cp >= 'a' && cp <= 'z') ||
           (cp >= 'A' && cp <= 'Z') || cp == '_';
  if (cp == 0xAA || cp == 0xB5 || cp == 0xBA) return true;
  if (cp >= 0xC0 && cp <= 0xFF && cp != 0xD7 && cp != 0xF7) return true;
  if (cp >= 0x100 && cp <= 0x24F) return true;          // Latin Ext-A/B
  if (cp >= 0x370 && cp <= 0x4FF) return true;          // Greek, Cyrillic
  if (cp >= 0x620 && cp <= 0x64A) return true;          // Arabic letters
  if (cp >= 0x66E && cp <= 0x6D3) return true;
  if (cp >= 0x660 && cp <= 0x669) return true;          // Arabic digits
  if (cp >= 0x1100 && cp <= 0x11FF) return true;        // Hangul
  if (cp >= 0x3130 && cp <= 0x318F) return true;
  if (cp >= 0xAC00 && cp <= 0xD7AF) return true;
  if (cp >= 0x4E00 && cp <= 0x9FFF) return true;        // CJK unified
  if (cp >= 0x3040 && cp <= 0x30FF) return true;        // kana
  return false;
}

inline int32_t bucket(uint64_t h, int32_t vocab_size) {
  return kReserved + (int32_t)(h % (uint64_t)(vocab_size - kReserved));
}

// One row: scan words, emit CLS + word/ngram buckets exactly like
// hash_tokenizer.encode_text (including its quirk that the >=max_len break
// happens only BETWEEN words, then truncates).
void encode_row(const char* text, int64_t len, int32_t vocab_size,
                int32_t max_len, int32_t ngram_min, int32_t ngram_max,
                int32_t ngrams_per_word, int32_t* ids, float* mask) {
  std::vector<int32_t> out;
  out.reserve(max_len + 16);
  out.push_back(kClsId);

  const unsigned char* p = (const unsigned char*)text;
  const unsigned char* end = p + len;
  // current word: UTF-8 bytes (for the word hash) + codepoint byte offsets
  // (Python slices n-grams by CODEPOINT; offsets let us hash codepoint
  // slices of the <word> form without re-encoding)
  std::string wbytes;
  std::vector<int> cp_off;       // byte offset of each codepoint in wbytes
  char enc[4];

  auto flush_word = [&]() {
    if (wbytes.empty()) return;
    if ((int)out.size() >= max_len) { wbytes.clear(); cp_off.clear(); return; }
    // word bucket
    out.push_back(bucket(fnv1a(wbytes.data(), wbytes.size()), vocab_size));
    int n_cp = (int)cp_off.size();
    if (n_cp > ngram_min && ngrams_per_word > 0) {
      // ext = "<" + word + ">"; ext codepoint count = n_cp + 2.  Python
      // emits, for n in [ngram_min, min(ngram_max, len(ext)-1)], the
      // non-overlapping stride-n slices ext[0:n], ext[n:2n], ... and takes
      // the first ngrams_per_word overall.
      std::string ext;
      ext.reserve(wbytes.size() + 2);
      ext.push_back('<');
      ext.append(wbytes);
      ext.push_back('>');
      std::vector<int> eoff;     // codepoint byte offsets into ext
      eoff.reserve(n_cp + 3);
      eoff.push_back(0);                               // '<'
      for (int o : cp_off) eoff.push_back(o + 1);      // word cps
      eoff.push_back((int)wbytes.size() + 1);          // '>'
      eoff.push_back((int)ext.size());                 // sentinel
      int ext_cp = n_cp + 2;
      int emitted = 0;
      int hi = ngram_max < ext_cp - 1 ? ngram_max : ext_cp - 1;
      for (int n = ngram_min; n <= hi && emitted < ngrams_per_word; ++n) {
        for (int i = 0; i + n <= ext_cp && emitted < ngrams_per_word; i += n) {
          // hash "#" + ext[i:i+n]
          uint64_t h = (kFnvOffset ^ (unsigned char)'#') * kFnvPrime;
          h = fnv1a(ext.data() + eoff[i], eoff[i + n] - eoff[i], h);
          out.push_back(bucket(h, vocab_size));
          ++emitted;
        }
      }
    }
    wbytes.clear();
    cp_off.clear();
  };

  bool prev_cased = false;       // Python lowers the RAW text first, so the
                                 // Final_Sigma context spans non-word chars
  while (p < end && (int)out.size() < max_len) {
    uint32_t cp;
    int n = decode_utf8(p, end, &cp);
    p += n;
    uint32_t lc = lower_cp(cp);
    if (cp == 0x3A3) {
      // Final_Sigma: "ΛΟΓΟΣ".lower() ends in ς (prev cased, next not)
      uint32_t next_cp = 0;
      if (p < end) decode_utf8(p, end, &next_cp);
      if (prev_cased && !is_cased_cp(next_cp)) lc = 0x3C2;
    }
    prev_cased = is_cased_cp(cp);
    if (is_hash_word_cp(cp)) {
      cp_off.push_back((int)wbytes.size());
      int m = encode_utf8(lc, enc);
      wbytes.append(enc, m);
    } else {
      flush_word();
    }
  }
  flush_word();

  int n_out = (int)out.size() < max_len ? (int)out.size() : max_len;
  std::memcpy(ids, out.data(), n_out * sizeof(int32_t));
  for (int i = 0; i < n_out; ++i) mask[i] = 1.0f;
}

}  // namespace

extern "C" {

// texts: UTF-8 blob + (n+1) byte offsets.  out_ids/out_mask: caller-zeroed
// (n, max_len) row-major buffers.  Rows are independent → threaded.
void tdr_hash_encode(const char* text_blob, const int64_t* text_offsets,
                     int64_t n_texts, int32_t vocab_size, int32_t max_len,
                     int32_t ngram_min, int32_t ngram_max,
                     int32_t ngrams_per_word,
                     int32_t* out_ids, float* out_mask) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      encode_row(text_blob + text_offsets[i],
                 text_offsets[i + 1] - text_offsets[i], vocab_size, max_len,
                 ngram_min, ngram_max, ngrams_per_word,
                 out_ids + i * max_len, out_mask + i * max_len);
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = hw ? (int64_t)hw : 1;
  if (n_threads > 8) n_threads = 8;
  if (n_texts < 4096 || n_threads <= 1) {
    work(0, n_texts);
    return;
  }
  std::vector<std::thread> pool;
  int64_t step = (n_texts + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * step, hi = lo + step < n_texts ? lo + step : n_texts;
    if (lo >= hi) break;
    pool.emplace_back(work, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
