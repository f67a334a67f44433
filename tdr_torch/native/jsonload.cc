// Copied from tdr/native/jsonload.cc.
// Native corpus.json parser (L0 data ingest, SURVEY.md §1).
//
// The reference loads its 268k-document corpus with Python json.load
// (bm25_ranking.ipynb "load_corpus"; cosine_similarity_bm25_reranking.py:
// 262-276) — minutes of interpreter time at real scale.  This is a
// single-pass streaming parser specialized to the corpus schema
//   [{"docid": ..., "text": "...", "lang": "..."}, ...]
// with full JSON string semantics (escapes, \uXXXX incl. surrogate pairs)
// and generic skipping of unknown keys/values.  Output is one packed blob
// of field strings + offsets, mirroring the tokenizer ABI (ctypes-bound in
// tdr/native/__init__.py; Python json.load remains the fallback and the
// parity oracle, tests/test_native.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Parser {
  const char* p;
  const char* end;
  const char* err = nullptr;

  explicit Parser(const char* buf, int64_t len) : p(buf), end(buf + len) {}

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }

  bool fail(const char* msg) {
    if (!err) err = msg;
    return false;
  }

  bool expect(char c) {
    ws();
    if (p >= end || *p != c) return fail("unexpected character");
    ++p;
    return true;
  }

  static void append_utf8(std::string* out, uint32_t cp) {
    if (cp < 0x80) {
      out->push_back((char)cp);
    } else if (cp < 0x800) {
      out->push_back((char)(0xC0 | (cp >> 6)));
      out->push_back((char)(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
      out->push_back((char)(0xE0 | (cp >> 12)));
      out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
      out->push_back((char)(0x80 | (cp & 0x3F)));
    } else {
      out->push_back((char)(0xF0 | (cp >> 18)));
      out->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
      out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
      out->push_back((char)(0x80 | (cp & 0x3F)));
    }
  }

  bool hex4(uint32_t* out) {
    if (end - p < 4) return fail("truncated \\u escape");
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) {
      char c = p[i];
      v <<= 4;
      if (c >= '0' && c <= '9') v |= (uint32_t)(c - '0');
      else if (c >= 'a' && c <= 'f') v |= (uint32_t)(c - 'a' + 10);
      else if (c >= 'A' && c <= 'F') v |= (uint32_t)(c - 'A' + 10);
      else return fail("bad hex digit in \\u escape");
    }
    p += 4;
    *out = v;
    return true;
  }

  // parse a JSON string (opening quote already consumed into check)
  bool string(std::string* out) {
    ws();
    if (p >= end || *p != '"') return fail("expected string");
    ++p;
    while (p < end) {
      // bulk-copy fast path: most corpus text has no escapes — copy the
      // whole unescaped span in one append instead of byte-at-a-time
      const char* run = p;
      while (p < end && *p != '"' && *p != '\\' &&
             (unsigned char)*p >= 0x20) ++p;
      if (p > run) out->append(run, (size_t)(p - run));
      if (p >= end) break;
      unsigned char c = (unsigned char)*p;
      // json.load (the declared parity oracle) rejects raw control bytes
      // inside strings — fail so such records route through the fallback
      if (c < 0x20) return fail("raw control character in string");
      if (c == '"') {
        ++p;
        return true;
      }
      if (c == '\\') {
        ++p;
        if (p >= end) return fail("truncated escape");
        char e = *p++;
        switch (e) {
          case '"': out->push_back('"'); break;
          case '\\': out->push_back('\\'); break;
          case '/': out->push_back('/'); break;
          case 'b': out->push_back('\b'); break;
          case 'f': out->push_back('\f'); break;
          case 'n': out->push_back('\n'); break;
          case 'r': out->push_back('\r'); break;
          case 't': out->push_back('\t'); break;
          case 'u': {
            uint32_t cp;
            if (!hex4(&cp)) return false;
            if (cp >= 0xD800 && cp <= 0xDBFF) {
              // high surrogate: a low surrogate must follow.  Lone
              // surrogates are an ERROR, not U+FFFD: json.load keeps them
              // as lone-surrogate str code points, which UTF-8 cannot
              // carry — failing here routes the record through the
              // json.load fallback so behavior matches the oracle.
              if (end - p >= 6 && p[0] == '\\' && p[1] == 'u') {
                p += 2;
                uint32_t lo;
                if (!hex4(&lo)) return false;
                if (lo < 0xDC00 || lo > 0xDFFF)
                  return fail("lone utf-16 surrogate escape");
                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              } else {
                return fail("lone utf-16 surrogate escape");
              }
            } else if (cp >= 0xDC00 && cp <= 0xDFFF) {
              return fail("lone utf-16 surrogate escape");
            }
            append_utf8(out, cp);
            break;
          }
          default:
            return fail("bad escape character");
        }
      }
    }
    return fail("unterminated string");
  }

  // capture an INTEGER literal verbatim (str(int) == the literal form).
  // Floats/exponents are rejected on purpose: Python str(float) does not
  // match the literal ("4e2" -> "400.0"), so those fall back to json.load
  // rather than silently diverging from the oracle; so does any bare
  // garbage token (json.load raises there).
  bool raw_int(std::string* out) {
    ws();
    const char* s = p;
    if (p < end && *p == '-') ++p;
    while (p < end && *p >= '0' && *p <= '9') ++p;
    if (p == s || (p == s + 1 && *s == '-'))
      return fail("non-integer docid literal");
    if (p < end && *p != ',' && *p != '}' && *p != ' ' && *p != '\t' &&
        *p != '\n' && *p != '\r')
      return fail("non-integer docid literal");
    out->assign(s, (size_t)(p - s));
    return true;
  }

  // skip a non-string scalar token (value of an unknown key)
  bool raw_scalar(std::string* out) {
    ws();
    const char* s = p;
    while (p < end && *p != ',' && *p != '}' && *p != ']' && *p != ' ' &&
           *p != '\t' && *p != '\n' && *p != '\r')
      ++p;
    if (p == s) return fail("empty value");
    out->assign(s, (size_t)(p - s));
    return true;
  }

  bool skip_value() {
    ws();
    if (p >= end) return fail("truncated value");
    char c = *p;
    if (c == '"') {
      std::string tmp;
      return string(&tmp);
    }
    if (c == '{' || c == '[') {
      char open = c, close = (c == '{') ? '}' : ']';
      int depth = 0;
      while (p < end) {
        char d = *p;
        if (d == '"') {
          std::string tmp;
          if (!string(&tmp)) return false;
          continue;
        }
        if (d == open) ++depth;
        if (d == close) {
          --depth;
          ++p;
          if (depth == 0) return true;
          continue;
        }
        ++p;
      }
      return fail("unterminated container");
    }
    std::string tmp;
    return raw_scalar(&tmp);
  }
};

}  // namespace

extern "C" {

struct TdrCorpusResult {
  char* blob;          // docid, text, lang per record, concatenated
  int64_t* offsets;    // 3*n_docs + 1 offsets into blob
  int64_t n_docs;
  int64_t blob_len;
  const char* error;   // static message, or null
};

TdrCorpusResult* tdr_parse_corpus(const char* buf, int64_t len) {
  auto* res = (TdrCorpusResult*)calloc(1, sizeof(TdrCorpusResult));
  Parser ps(buf, len);
  std::string blob;
  std::vector<int64_t> offsets;
  offsets.push_back(0);
  blob.reserve((size_t)(len > 0 ? len : 1));
  int64_t n = 0;

  if (!ps.expect('[')) {
    res->error = ps.err;
    return res;
  }
  ps.ws();
  if (ps.p < ps.end && *ps.p == ']') {
    ++ps.p;
  } else {
    while (true) {
      if (!ps.expect('{')) break;
      std::string docid, text, lang = "en";
      bool have_docid = false, have_text = false;
      bool ok = true;
      ps.ws();
      if (ps.p < ps.end && *ps.p == '}') {
        ++ps.p;
      } else {
        while (ok) {
          std::string key;
          if (!(ok = ps.string(&key))) break;
          if (!(ok = ps.expect(':'))) break;
          ps.ws();
          // string() appends — clear for duplicate-key last-wins, the
          // json.load (parity oracle) behavior
          if (key == "docid") {
            docid.clear();
            have_docid = true;
            // str(r["docid"]) semantics: ints keep their literal form
            ok = (ps.p < ps.end && *ps.p == '"') ? ps.string(&docid)
                                                 : ps.raw_int(&docid);
          } else if (key == "text") {
            text.clear();
            have_text = true;
            ok = ps.string(&text);
          } else if (key == "lang") {
            lang.clear();
            ok = ps.string(&lang);
          } else {
            ok = ps.skip_value();
          }
          if (!ok) break;
          ps.ws();
          if (ps.p < ps.end && *ps.p == ',') {
            ++ps.p;
            continue;
          }
          ok = ps.expect('}');
          break;
        }
      }
      if (!ok) break;
      if (!have_docid || !have_text) {
        // json.load path raises KeyError here — report an error so the
        // caller falls back and surfaces the data problem the same way
        ps.fail(!have_docid ? "record missing docid" : "record missing text");
        break;
      }
      blob += docid;
      offsets.push_back((int64_t)blob.size());
      blob += text;
      offsets.push_back((int64_t)blob.size());
      blob += lang;
      offsets.push_back((int64_t)blob.size());
      ++n;
      ps.ws();
      if (ps.p < ps.end && *ps.p == ',') {
        ++ps.p;
        continue;
      }
      if (!ps.expect(']')) break;
      break;
    }
  }

  if (!ps.err) {
    // only whitespace may follow the closing ']' (json.load: "Extra data")
    ps.ws();
    if (ps.p < ps.end) ps.fail("trailing data after corpus array");
  }
  if (ps.err) {
    res->error = ps.err;
    return res;
  }
  res->n_docs = n;
  res->blob_len = (int64_t)blob.size();
  res->blob = (char*)malloc(blob.size() ? blob.size() : 1);
  memcpy(res->blob, blob.data(), blob.size());
  res->offsets = (int64_t*)malloc(offsets.size() * sizeof(int64_t));
  memcpy(res->offsets, offsets.data(), offsets.size() * sizeof(int64_t));
  return res;
}

void tdr_free_corpus(TdrCorpusResult* r) {
  if (!r) return;
  free(r->blob);
  free(r->offsets);
  free(r);
}

}  // extern "C"
