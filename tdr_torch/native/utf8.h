// Copied from tdr/native/utf8.h.
// Shared UTF-8 + codepoint helpers for the tdr native host library.
//
// Extracted from tokenizer.cc so the hash encoder (hashenc.cc) reuses the
// exact same decode/lowercase tables — the dense-encoder feature hashing
// must produce identical ids no matter which translation unit touched the
// text first.

#ifndef TDR_NATIVE_UTF8_H_
#define TDR_NATIVE_UTF8_H_

#include <cstdint>

namespace tdrnat {

// ---------------- UTF-8 ----------------

inline int decode_utf8(const unsigned char* s, const unsigned char* end,
                       uint32_t* cp) {
  unsigned char c = s[0];
  if (c < 0x80) { *cp = c; return 1; }
  if ((c >> 5) == 0x6 && s + 1 < end) {
    *cp = ((c & 0x1F) << 6) | (s[1] & 0x3F);
    return 2;
  }
  if ((c >> 4) == 0xE && s + 2 < end) {
    *cp = ((c & 0x0F) << 12) | ((s[1] & 0x3F) << 6) | (s[2] & 0x3F);
    return 3;
  }
  if ((c >> 3) == 0x1E && s + 3 < end) {
    *cp = ((c & 0x07) << 18) | ((s[1] & 0x3F) << 12) | ((s[2] & 0x3F) << 6) |
          (s[3] & 0x3F);
    return 4;
  }
  *cp = 0xFFFD;
  return 1;
}

inline int encode_utf8(uint32_t cp, char* out) {
  if (cp < 0x80) { out[0] = (char)cp; return 1; }
  if (cp < 0x800) {
    out[0] = (char)(0xC0 | (cp >> 6));
    out[1] = (char)(0x80 | (cp & 0x3F));
    return 2;
  }
  if (cp < 0x10000) {
    out[0] = (char)(0xE0 | (cp >> 12));
    out[1] = (char)(0x80 | ((cp >> 6) & 0x3F));
    out[2] = (char)(0x80 | (cp & 0x3F));
    return 3;
  }
  out[0] = (char)(0xF0 | (cp >> 18));
  out[1] = (char)(0x80 | ((cp >> 12) & 0x3F));
  out[2] = (char)(0x80 | ((cp >> 6) & 0x3F));
  out[3] = (char)(0x80 | (cp & 0x3F));
  return 4;
}

// ---------------- classification / case ----------------

inline bool is_hangul(uint32_t cp) {
  return (cp >= 0xAC00 && cp <= 0xD7AF) || (cp >= 0x1100 && cp <= 0x11FF) ||
         (cp >= 0x3130 && cp <= 0x318F);
}

inline uint32_t lower_cp(uint32_t cp) {
  if (cp >= 'A' && cp <= 'Z') return cp + 32;
  if (cp >= 0xC0 && cp <= 0xDE && cp != 0xD7) return cp + 32;  // Latin-1
  // Latin Extended-A: case pairs alternate parity across three sub-ranges
  // (0x100-0x137 and 0x14A-0x177 are even-upper; 0x139-0x148 and
  // 0x179-0x17D are odd-upper).
  if ((cp >= 0x100 && cp <= 0x137) || (cp >= 0x14A && cp <= 0x177))
    return (cp % 2 == 0) ? cp + 1 : cp;
  if ((cp >= 0x139 && cp <= 0x148) || (cp >= 0x179 && cp <= 0x17D))
    return (cp % 2 == 1) ? cp + 1 : cp;
  if (cp == 0x178) return 0xFF;  // Y with diaeresis
  // Greek (final-sigma handled contextually at token flush)
  if (cp == 0x386) return 0x3AC;
  if (cp >= 0x388 && cp <= 0x38A) return cp + 0x25;
  if (cp == 0x38C) return 0x3CC;
  if (cp == 0x38E || cp == 0x38F) return cp + 0x3F;
  if ((cp >= 0x391 && cp <= 0x3A1) || (cp >= 0x3A3 && cp <= 0x3AB))
    return cp + 32;
  // Cyrillic
  if (cp >= 0x400 && cp <= 0x40F) return cp + 80;
  if (cp >= 0x410 && cp <= 0x42F) return cp + 32;
  return cp;
}

// Unicode "cased" approximation for the scripts this library lowercases;
// the Final_Sigma rule requires the preceding character to be cased (digits
// are not: "1Σ".lower() == "1σ" but "ΑΣ".lower() == "ας").
inline bool is_cased_cp(uint32_t cp) {
  return (cp >= 'a' && cp <= 'z') || (cp >= 'A' && cp <= 'Z') ||
         (cp >= 0xC0 && cp <= 0xFF && cp != 0xD7 && cp != 0xF7) ||
         (cp >= 0x100 && cp <= 0x24F) || (cp >= 0x370 && cp <= 0x4FF);
}

// Arabic normalization: returns 0 to drop (diacritic/tatweel), else the
// normalized codepoint.
inline uint32_t normalize_arabic_cp(uint32_t cp) {
  if (cp >= 0x610 && cp <= 0x61A) return 0;            // signs
  if (cp >= 0x64B && cp <= 0x65F) return 0;            // tashkeel
  if (cp == 0x640) return 0;                           // tatweel
  if (cp == 0x670 || (cp >= 0x6D6 && cp <= 0x6ED)) return 0;
  switch (cp) {
    case 0x623: case 0x625: case 0x622: return 0x627;  // alef forms -> alef
    case 0x629: return 0x647;                          // teh marbuta -> heh
    case 0x649: return 0x64A;                          // alef maksura -> yeh
    case 0x624: return 0x648;                          // waw+hamza -> waw
    case 0x626: return 0x64A;                          // yeh+hamza -> yeh
  }
  return cp;
}

}  // namespace tdrnat

#endif  // TDR_NATIVE_UTF8_H_
