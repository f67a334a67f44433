# Copied from tdr/text/hash_tokenizer.py; ``encode_batch`` calls the port's
# own native hasher (tdr_torch/native/hashenc.cc).
"""Data-free multilingual tokenizer for the dense encoder.

The reference's dense path uses HuggingFace subword tokenizers
(paraphrase-multilingual-MiniLM, team_run1.py:211-217;
text_preprocessing_setup.py:132-151).  Model files are not available in this
environment and a framework tokenizer shouldn't require downloads, so the
dense encoder uses deterministic feature hashing (fastText-style): each
word maps to a bucket id via FNV-1a, optionally augmented with character
n-gram buckets so morphology-rich languages (de compounds, ko agglutination)
share subword signal.

Vocabulary ids: 0 = PAD, 1 = CLS; word/ngram buckets occupy [2, vocab_size).
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np

_WORD_RE = re.compile(r"\w+", re.UNICODE)

PAD_ID = 0
CLS_ID = 1
_RESERVED = 2

_FNV_OFFSET = 14695981039346656037
_FNV_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1


def fnv1a(s: str) -> int:
    h = _FNV_OFFSET
    for b in s.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def hash_token(s: str, vocab_size: int) -> int:
    return _RESERVED + fnv1a(s) % (vocab_size - _RESERVED)


def encode_text(
    text: str,
    vocab_size: int,
    max_len: int = 128,
    ngram_min: int = 3,
    ngram_max: int = 5,
    ngrams_per_word: int = 2,
) -> List[int]:
    """Text → hashed token ids (word buckets + a few char-ngram buckets)."""
    ids: List[int] = [CLS_ID]
    for w in _WORD_RE.findall(text.lower()):
        ids.append(hash_token(w, vocab_size))
        if len(w) > ngram_min and ngrams_per_word > 0:
            ext = f"<{w}>"
            grams = []
            for n in range(ngram_min, min(ngram_max, len(ext) - 1) + 1):
                grams.extend(ext[i:i + n] for i in range(0, len(ext) - n + 1, n))
            for g in grams[:ngrams_per_word]:
                ids.append(hash_token("#" + g, vocab_size))
        if len(ids) >= max_len:
            break
    return ids[:max_len]


def encode_batch_python(
    texts: Sequence[str],
    vocab_size: int,
    max_len: int = 128,
) -> Tuple[np.ndarray, np.ndarray]:
    """``encode_batch`` through the pure-Python loop: the semantic oracle the
    native path is held against."""
    B = len(texts)
    ids = np.zeros((B, max_len), np.int32)
    mask = np.zeros((B, max_len), np.float32)
    for i, t in enumerate(texts):
        enc = encode_text(t, vocab_size, max_len)
        ids[i, : len(enc)] = enc
        mask[i, : len(enc)] = 1.0
    return ids, mask


def encode_batch(
    texts: Sequence[str],
    vocab_size: int,
    max_len: int = 128,
) -> Tuple[np.ndarray, np.ndarray]:
    """Texts → (ids (B, L) int32, mask (B, L) float32).

    Uses the native C++ hasher (tdr_torch/native/hashenc.cc) — the
    per-character Python FNV loop dominates the corpus-wide embedding pass
    otherwise — and takes ``encode_batch_python`` only when the native
    library cannot be built or loaded.
    """
    if texts:
        from tdr_torch import native

        if native.available():
            return native.hash_encode_batch(texts, vocab_size, max_len)
    return encode_batch_python(texts, vocab_size, max_len)
