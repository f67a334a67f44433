# Copied from tdr/text/langid.py; only the imports are rewritten.
"""Deterministic, data-free language identification.

The reference's sentence-level pipeline detects language per text with
``fast_langdetect`` (a fasttext C++ model, team_run1.py:49-77) and falls back
to 'en' on failure.  Here: script detection handles ar/ko exactly; latin
languages are separated by stopword-hit voting — deterministic, no model
files, and accurate enough for routing whole documents/queries (the only use
in the retrieval stack).
"""

from __future__ import annotations

import re
from typing import Iterable

from tdr_torch.text.stopwords import stopwords_for

_ARABIC = re.compile(r"[؀-ۿ]")
_HANGUL = re.compile(r"[가-힯ᄀ-ᇿ㄰-㆏]")
_WORD = re.compile(r"[a-zà-ÿäöüßáéíóúñìòù]+", re.IGNORECASE)

_LATIN_LANGS = ("en", "fr", "de", "es", "it")
_MARKER_CHARS = {
    "de": set("äöüß"),
    "fr": set("àâçèéêëîïôùûœ"),
    "es": set("áéíñóúü¿¡"),
    "it": set("àèéìòù"),
}


def detect_language(text: str, default: str = "en") -> str:
    sample = text[:2000].lower()
    n_ar = len(_ARABIC.findall(sample))
    n_ko = len(_HANGUL.findall(sample))
    if n_ar > 0 or n_ko > 0:
        return "ar" if n_ar >= n_ko else "ko"

    words = _WORD.findall(sample)
    if not words:
        return default
    scores = {}
    for lang in _LATIN_LANGS:
        sw = stopwords_for(lang)
        scores[lang] = sum(1 for w in words if w in sw)
    # accent-character tiebreak/boost
    for lang, chars in _MARKER_CHARS.items():
        scores[lang] = scores.get(lang, 0) + 2 * sum(1 for c in sample if c in chars)
    best = max(scores, key=scores.get)
    return best if scores[best] > 0 else default


def detect_languages(texts: Iterable[str], default: str = "en"):
    return [detect_language(t, default) for t in texts]
