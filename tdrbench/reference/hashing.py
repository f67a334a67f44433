"""The reference's tokenizer for the dense encoder: fastText-style feature
hashing (FNV-1a 64 of each lowercased word run, then of its first two
character n-grams of length 3-5 taken without overlap from "<word>", each
as "#" + gram), ids offset past PAD 0 and CLS 1, CLS first, at most
``max_len`` ids.  Written after the description of the program's
``text.hash_tokenizer``; nothing here imports the program."""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

_WORD = re.compile(r"\w+")
_OFFSET = 14695981039346656037
_PRIME = 1099511628211
_MASK = (1 << 64) - 1


def fnv1a(s: str) -> int:
    h = _OFFSET
    for byte in s.encode("utf-8"):
        h = ((h ^ byte) * _PRIME) & _MASK
    return h


class Hasher:
    def __init__(self, vocab_size: int, max_len: int):
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.memo: Dict[str, Tuple[int, ...]] = {}

    def _bucket(self, s: str) -> int:
        return 2 + fnv1a(s) % (self.vocab_size - 2)

    def word(self, w: str) -> Tuple[int, ...]:
        out = self.memo.get(w)
        if out is None:
            ids = [self._bucket(w)]
            if len(w) > 3:
                ext = f"<{w}>"
                grams = [ext[i:i + n] for n in range(3, min(5, len(ext) - 1) + 1)
                         for i in range(0, len(ext) - n + 1, n)]
                ids += [self._bucket("#" + g) for g in grams[:2]]
            out = self.memo[w] = tuple(ids)
        return out

    def encode(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.zeros((len(texts), self.max_len), np.int64)
        mask = np.zeros((len(texts), self.max_len), np.float32)
        for r, text in enumerate(texts):
            row: List[int] = [1]
            for w in _WORD.findall(text.lower()):
                row += self.word(w)
                if len(row) >= self.max_len:
                    break
            row = row[: self.max_len]
            ids[r, : len(row)] = row
            mask[r, : len(row)] = 1.0
        return ids, mask
