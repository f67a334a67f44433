# Copied from tdr/text/ko.py; only the imports are rewritten.
"""Korean tokenization without the JVM.

The reference uses KoNLPy's Okt morphological analyzer (Java) to split Korean
text into morphemes (bm25_ranking.ipynb:92, final_implementation.py:60,69-70).
A JVM dependency is out for this framework (SURVEY.md §7 "Korean tokenizer
without JVM"), so this module implements a deterministic, data-free
approximation that captures what matters for retrieval: separating content
stems from the postpositional particles (josa) and common verbal endings
(eomi) that Okt splits off.

Algorithm: script-segment the text (Hangul runs vs other runs), then for each
Hangul token greedily strip the longest matching particle/ending suffix as
long as a stem of >= 1 syllable remains.  Both the stem and (optionally) the
stripped particle are emitted — Okt's `morphs` likewise emits particles as
separate morphemes; the stopword filter then removes most particles.
"""

from __future__ import annotations

import re
from typing import List

# Postpositional particles (josa), case markers, and high-frequency verbal /
# adjectival endings (eomi).  Ordered by length at runtime (longest match).
_SUFFIXES = [
    # case / topic / additive particles
    "은", "는", "이", "가", "을", "를", "의", "에", "와", "과", "도", "만",
    "께", "에서", "에게", "한테", "으로", "로", "보다", "부터", "까지", "마다",
    "처럼", "같이", "조차", "마저", "밖에", "에게서", "한테서", "으로서",
    "으로써", "로서", "로써", "이나", "나", "이라도", "라도", "이며", "며",
    "하고", "이랑", "랑", "에다", "에다가", "이든", "든", "이든지", "든지",
    # copula / light-verb endings
    "입니다", "습니다", "합니다", "했습니다", "됩니다", "있습니다", "없습니다",
    "이다", "하다", "했다", "한다", "하는", "하게", "하지", "하여", "해서",
    "하고", "하며", "하면", "되다", "되는", "되어", "됐다", "된다", "된",
    "이었다", "였다", "이에요", "예요", "이죠", "죠", "네요", "어요", "아요",
    "습니까", "합니까", "인가", "일까", "에요",
]
_SUFFIXES = sorted(set(_SUFFIXES), key=len, reverse=True)

_HANGUL_RE = re.compile(r"[가-힯ᄀ-ᇿ㄰-㆏]+")
_NONWORD_SPLIT = re.compile(r"[^\w]+", re.UNICODE)


def strip_particle(token: str) -> List[str]:
    """Split one Hangul token into [stem] or [stem, particle]."""
    for suf in _SUFFIXES:
        if token.endswith(suf) and len(token) > len(suf):
            return [token[: -len(suf)], suf]
    return [token]


def tokenize_korean(text: str, emit_particles: bool = True) -> List[str]:
    """Approximate Okt.morphs: script-aware word split + particle detachment."""
    out: List[str] = []
    for raw in _NONWORD_SPLIT.split(text):
        if not raw:
            continue
        # split mixed tokens into hangul runs and non-hangul runs
        pos = 0
        for m in _HANGUL_RE.finditer(raw):
            if m.start() > pos:
                out.append(raw[pos:m.start()].lower())
            parts = strip_particle(m.group())
            out.append(parts[0])
            if emit_particles and len(parts) > 1:
                out.append(parts[1])
            pos = m.end()
        if pos < len(raw):
            out.append(raw[pos:].lower())
    return [t for t in out if t]
