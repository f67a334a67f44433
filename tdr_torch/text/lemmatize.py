# Copied from tdr/text/lemmatize.py; the Snowball and Porter stemmers come
# from the vendored snowball.py and porter.py.
"""Rule-based English lemmatizer + Snowball stemmer registry.

The winning reference pipeline lemmatizes English with WordNet (default noun
POS) and Snowball-stems fr/de/es/it (bm25_ranking.ipynb:96-104,
final_implementation.py:74-84).  WordNet's data files are not available here,
so English uses WordNet's *morphy* suffix-detachment rules (the algorithmic
part of the WordNet lemmatizer) without the exception lists; fr/de/es/it use
NLTK's pure-code Snowball stemmers, vendored in ``snowball.py`` (and the
Porter stemmer in ``porter.py``) so nltk is not needed.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

from tdr_torch.text.porter import PorterStemmer
from tdr_torch.text.snowball import (
    FrenchStemmer,
    GermanStemmer,
    ItalianStemmer,
    SpanishStemmer,
)

# WordNet morphy detachment rules for nouns (suffix -> replacement), applied
# longest-first; a rewrite is accepted if it leaves >= 2 characters.
_NOUN_RULES = [
    ("ches", "ch"),
    ("shes", "sh"),
    ("xes", "x"),
    ("zes", "z"),
    ("ses", "s"),
    ("ies", "y"),
    ("men", "man"),
    ("s", ""),
]

_KEEP_S = frozenset(
    "is was has this thus its his hers ours yours theirs as us bus gas lens news "
    "series species analysis basis crisis physics mathematics politics economics "
    "classics athletics statistics".split()
)


def lemmatize_en(word: str) -> str:
    """Noun-POS lemmatization à la WordNet morphy (rules only)."""
    if word.endswith("men") and len(word) > 3:
        return word[:-3] + "man"
    if len(word) <= 2 or not word.endswith("s") or word in _KEEP_S:
        return word
    if word.endswith("ss") or word.endswith("us"):
        return word
    for suf, rep in _NOUN_RULES:
        if word.endswith(suf):
            stem = word[: -len(suf)] + rep
            if len(stem) >= 2:
                return stem
    return word


_SNOWBALL = {
    "fr": FrenchStemmer,
    "de": GermanStemmer,
    "es": SpanishStemmer,
    "it": ItalianStemmer,
}


@lru_cache(maxsize=8)
def _snowball(lang: str):
    return _SNOWBALL[lang]()


@lru_cache(maxsize=1)
def _porter() -> PorterStemmer:
    return PorterStemmer()


def normalizer_for(lang: str, scheme: str = "best") -> Callable[[str], str]:
    """Return the token normalizer for (lang, scheme).

    scheme="best": en -> morphy lemmatizer; fr/de/es/it -> Snowball stem;
                   ar/ko -> identity (the reference applies neither).
    scheme="porter": PorterStemmer for every language (the v2 pipelines,
                   cosine_similarity_bm25_reranking.py:59-63 — applied there
                   via a buggy str.replace; here applied per-token).
    scheme="none": identity.
    """
    if scheme == "none":
        return lambda w: w
    if scheme == "porter":
        return _porter().stem
    if lang == "en":
        return lemmatize_en
    if lang in ("fr", "de", "es", "it"):
        return _snowball(lang).stem
    return lambda w: w
