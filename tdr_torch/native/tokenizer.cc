// Copied from tdr/native/tokenizer.cc.
// tdr native host tokenizer.
//
// The reference's corpus preprocessing is its slowest stage (it pickles every
// intermediate to avoid re-running it — SURVEY.md §7 "host/device split").
// This library implements the string-heavy part of the pipeline in C++:
//
//   UTF-8 scan -> codepoint classification (letter/digit per script) ->
//   lowercase (ASCII + Latin-1 + Latin-Extended-A) -> Arabic normalization
//   (diacritic strip, alef/teh/yeh unification) -> Korean particle/ending
//   suffix detachment (suffix table supplied by Python) -> stopword filter
//   (hash set supplied by Python) -> token interning to int32 ids.
//
// Morphological normalization (lemmatize/stem) happens in Python on the
// UNIQUE vocabulary only (vocab << token stream), then id-mapping, bigram
// augmentation and counting are vectorized numpy — so the per-token string
// work, which dominates, stays native.
//
// C ABI (ctypes):  tdr_tokenize_batch / tdr_free_result.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "utf8.h"

namespace {

using tdrnat::decode_utf8;
using tdrnat::encode_utf8;
using tdrnat::is_hangul;
using tdrnat::is_cased_cp;
using tdrnat::lower_cp;
using tdrnat::normalize_arabic_cp;

// ---------------- classification ----------------

inline bool is_word_cp(uint32_t cp) {
  // NB '_' is a SEPARATOR: the Python pipeline translates string.punctuation
  // (which contains '_') to spaces before tokenizing, so "quick_brown" must
  // split into two tokens on both paths.
  if (cp < 0x80)
    return (cp >= '0' && cp <= '9') || (cp >= 'a' && cp <= 'z') ||
           (cp >= 'A' && cp <= 'Z');
  // Latin-1 supplement letters
  if (cp >= 0xC0 && cp <= 0xFF && cp != 0xD7 && cp != 0xF7) return true;
  // Latin Extended-A/B
  if (cp >= 0x100 && cp <= 0x24F) return true;
  // Greek, Cyrillic
  if (cp >= 0x370 && cp <= 0x4FF) return true;
  // Arabic letters (diacritics handled by normalization)
  if (cp >= 0x620 && cp <= 0x64A) return true;
  if (cp >= 0x66E && cp <= 0x6D3) return true;
  // Arabic digits
  if (cp >= 0x660 && cp <= 0x669) return true;
  // Hangul jamo + syllables + compatibility jamo
  if (cp >= 0x1100 && cp <= 0x11FF) return true;
  if (cp >= 0x3130 && cp <= 0x318F) return true;
  if (cp >= 0xAC00 && cp <= 0xD7AF) return true;
  // CJK unified
  if (cp >= 0x4E00 && cp <= 0x9FFF) return true;
  // Hiragana/Katakana
  if (cp >= 0x3040 && cp <= 0x30FF) return true;
  return false;
}

struct Interner {
  std::unordered_map<std::string, int32_t> map;
  std::vector<std::string> strings;

  int32_t intern(const std::string& s) {
    auto it = map.find(s);
    if (it != map.end()) return it->second;
    int32_t id = (int32_t)strings.size();
    map.emplace(s, id);
    strings.push_back(s);
    return id;
  }
};

struct SuffixTable {
  // Korean particle/ending suffixes sorted by byte length (longest first)
  std::vector<std::string> suffixes;
};

}  // namespace

extern "C" {

struct TdrResult {
  int32_t* token_ids;    // concatenated per-doc raw token ids
  int64_t* doc_offsets;  // (n_docs + 1)
  char* vocab_blob;      // vocab strings joined by '\n'
  int64_t n_tokens;
  int64_t n_docs;
  int64_t vocab_blob_len;
  int32_t vocab_size;
};

// langs: one byte per doc: 'l' latin, 'a' arabic, 'k' korean
// stopwords / suffixes: '\n'-joined UTF-8 blobs
TdrResult* tdr_tokenize_batch(
    const char* text_blob, const int64_t* text_offsets, int64_t n_docs,
    const char* lang_codes,
    const char* stopword_blob, int64_t stopword_len,
    const char* suffix_blob, int64_t suffix_len,
    int32_t emit_particles, int32_t min_len_latin) {
  // parse stopwords
  std::unordered_set<std::string> stopwords;
  {
    const char* p = stopword_blob;
    const char* end = stopword_blob + stopword_len;
    while (p < end) {
      const char* nl = (const char*)memchr(p, '\n', end - p);
      if (!nl) nl = end;
      if (nl > p) stopwords.emplace(p, nl - p);
      p = nl + 1;
    }
  }
  // parse korean suffixes (longest first)
  SuffixTable suffix;
  {
    const char* p = suffix_blob;
    const char* end = suffix_blob + suffix_len;
    while (p < end) {
      const char* nl = (const char*)memchr(p, '\n', end - p);
      if (!nl) nl = end;
      if (nl > p) suffix.suffixes.emplace_back(p, nl - p);
      p = nl + 1;
    }
    std::sort(suffix.suffixes.begin(), suffix.suffixes.end(),
              [](const std::string& a, const std::string& b) {
                return a.size() > b.size();
              });
  }

  Interner interner;
  std::vector<int32_t> token_ids;
  std::vector<int64_t> doc_offsets;
  doc_offsets.reserve(n_docs + 1);
  doc_offsets.push_back(0);
  token_ids.reserve(1 << 20);

  std::string tok;
  tok.reserve(64);
  char enc[4];
  bool prev_cased = false;       // was the previous codepoint in tok cased?
  bool final_sigma = false;      // does tok currently end in a lowered Σ
                                 // preceded by a cased letter?

  auto flush_token = [&](char mode) {
    // Final_Sigma: "ΛΟΓΟΣ".lower() == "λογος" — a capital sigma at word end
    // (with a cased letter before it) lowers to ς (0xCF 0x82), not σ.
    if (final_sigma && tok.size() >= 2 &&
        (unsigned char)tok[tok.size() - 2] == 0xCF &&
        (unsigned char)tok[tok.size() - 1] == 0x83) {
      tok[tok.size() - 1] = (char)0x82;
    }
    prev_cased = false;
    final_sigma = false;
    if (tok.empty()) return;
    size_t min_bytes = (mode == 'l') ? (size_t)min_len_latin : 1;
    // min_len_latin counts CODEPOINTS; for latin lowercase ASCII ~= bytes,
    // but accented chars are 2 bytes — count codepoints properly
    if (mode == 'l') {
      size_t ncp = 0;
      for (unsigned char c : tok)
        if ((c & 0xC0) != 0x80) ncp++;
      if (ncp < (size_t)min_len_latin) { tok.clear(); return; }
    }
    (void)min_bytes;
    if (stopwords.count(tok)) { tok.clear(); return; }
    token_ids.push_back(interner.intern(tok));
    tok.clear();
  };

  auto emit_korean = [&](std::string word) {
    // longest-match particle/ending strip (tdr.text.ko semantics)
    for (const auto& suf : suffix.suffixes) {
      if (word.size() > suf.size() &&
          word.compare(word.size() - suf.size(), suf.size(), suf) == 0) {
        std::string stem = word.substr(0, word.size() - suf.size());
        if (!stopwords.count(stem)) token_ids.push_back(interner.intern(stem));
        if (emit_particles && !stopwords.count(suf))
          token_ids.push_back(interner.intern(suf));
        return;
      }
    }
    if (!stopwords.count(word)) token_ids.push_back(interner.intern(word));
  };

  for (int64_t d = 0; d < n_docs; ++d) {
    const unsigned char* p =
        (const unsigned char*)(text_blob + text_offsets[d]);
    const unsigned char* end =
        (const unsigned char*)(text_blob + text_offsets[d + 1]);
    char mode = lang_codes[d];

    std::string kword;  // current hangul run (korean mode)
    bool in_hangul = false;

    auto flush_korean = [&]() {
      if (!kword.empty()) emit_korean(std::move(kword));
      kword.clear();
    };

    while (p < end) {
      uint32_t cp;
      int n = decode_utf8(p, end, &cp);
      p += n;
      if (mode == 'a') {
        cp = normalize_arabic_cp(cp);
        if (cp == 0) continue;
      }
      // '_' parity is mode-dependent: the latin pipeline translates
      // string.punctuation (incl '_') to spaces before tokenizing, but the
      // ar/ko pipelines tokenize the raw text where '_' is a word char
      // (preprocess.py: only the 'else' branch applies _PUNCT_TABLE)
      bool word = is_word_cp(cp) || (cp == '_' && mode != 'l');
      if (!word) {
        if (mode == 'k') { flush_korean(); }
        flush_token(mode == 'k' ? 'x' : mode);
        in_hangul = false;
        continue;
      }
      uint32_t orig = cp;
      cp = lower_cp(cp);
      if (mode == 'k') {
        bool h = is_hangul(cp);
        if (h != in_hangul) {
          // script boundary inside a word: flush the other script's run
          if (in_hangul) flush_korean();
          else flush_token('x');
          in_hangul = h;
        }
        int m = encode_utf8(cp, enc);
        if (h) kword.append(enc, m);
        else {
          final_sigma = (orig == 0x3A3) && prev_cased;
          prev_cased = is_cased_cp(orig);
          tok.append(enc, m);
        }
      } else {
        final_sigma = (orig == 0x3A3) && prev_cased;
        prev_cased = is_cased_cp(orig);
        int m = encode_utf8(cp, enc);
        tok.append(enc, m);
      }
    }
    if (mode == 'k') flush_korean();
    flush_token(mode == 'k' ? 'x' : mode);
    doc_offsets.push_back((int64_t)token_ids.size());
  }

  // assemble result
  TdrResult* res = new TdrResult();
  res->n_tokens = (int64_t)token_ids.size();
  res->n_docs = n_docs;
  res->vocab_size = (int32_t)interner.strings.size();
  res->token_ids = new int32_t[token_ids.size() ? token_ids.size() : 1];
  memcpy(res->token_ids, token_ids.data(), token_ids.size() * sizeof(int32_t));
  res->doc_offsets = new int64_t[doc_offsets.size()];
  memcpy(res->doc_offsets, doc_offsets.data(),
         doc_offsets.size() * sizeof(int64_t));
  size_t blob_len = 0;
  for (const auto& s : interner.strings) blob_len += s.size() + 1;
  res->vocab_blob = new char[blob_len ? blob_len : 1];
  {
    char* q = res->vocab_blob;
    for (const auto& s : interner.strings) {
      memcpy(q, s.data(), s.size());
      q += s.size();
      *q++ = '\n';
    }
  }
  res->vocab_blob_len = (int64_t)blob_len;
  return res;
}

void tdr_free_result(TdrResult* res) {
  if (!res) return;
  delete[] res->token_ids;
  delete[] res->doc_offsets;
  delete[] res->vocab_blob;
  delete res;
}

}  // extern "C"
