# Copied from tdr/text/preprocess.py; only the imports are rewritten.
"""Multilingual host-side preprocessing pipelines (layer L1).

Re-implements the reference's preprocessor family (SURVEY.md §2a) as one
configurable ``Preprocessor`` with named pipeline presets:

* ``"best"``  — the winning pipeline (bm25_ranking.ipynb:84-110,
  final_implementation.py:59-88): punctuation strip → word tokenize
  (morpheme split for ko, whitespace for ar) → stopword-union filter →
  lemmatize (en) / Snowball stem (fr,de,es,it) → append joined 2-grams
  for fr/de/es/it.
* ``"porter"`` — the v2 pipelines (cosine_similarity_bm25_reranking.py:45-68):
  lowercase, regex punctuation strip, per-language stopwords, Porter stem.
  (The reference applied Porter via pandas ``str.replace`` — a substring
  bug; here it is applied per-token, which is what the code intended.)
* ``"regex"``  — the lemmatizer-regex variant
  (corpus_processing_and_embedding.py:54-67): strips non-[a-z0-9] so it
  destroys ar/ko script — kept for behavioral parity, flagged in the doc.
* ``"rich"``   — the rich-cleanup variant
  (text_preprocessing_and_stopwords_setup.py:53-73): lowercase, HTML strip,
  contraction expansion, URL removal, punctuation/number removal,
  stopwords, lemmatize.

All pipelines are deterministic and data-free (no runtime downloads).
"""

from __future__ import annotations

import re
import string
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

from tdr_torch.text.ko import tokenize_korean
from tdr_torch.text.lemmatize import normalizer_for
from tdr_torch.text.stopwords import stopwords_for, stopword_union

BIGRAM_LANGS = frozenset({"fr", "de", "es", "it"})

_PUNCT_TABLE = str.maketrans({c: " " for c in string.punctuation})
_WORD_RE = re.compile(r"\w+", re.UNICODE)
_URL_RE = re.compile(r"https?://\S+|www\.\S+")
_HTML_RE = re.compile(r"<[^>]+>")
_NUM_RE = re.compile(r"\d+")
_ASCII_ALNUM_RE = re.compile(r"[^a-z0-9\s]")

# Arabic normalization: strip tashkeel/tatweel, unify alef/teh-marbuta/yeh.
_AR_DIACRITICS = re.compile(r"[ؐ-ًؚ-ٰٟۖ-ۜ۟-۪ۨ-ۭـ]")
_AR_MAP = str.maketrans({"أ": "ا", "إ": "ا", "آ": "ا", "ة": "ه", "ى": "ي", "ؤ": "و", "ئ": "ي"})

_CONTRACTIONS = {
    "can't": "can not", "won't": "will not", "n't": " not", "'re": " are",
    "'ve": " have", "'ll": " will", "'d": " would", "'m": " am", "it's": "it is",
    "let's": "let us", "'s": "",
}


def normalize_arabic(text: str) -> str:
    return _AR_DIACRITICS.sub("", text).translate(_AR_MAP)


def word_tokenize(text: str) -> List[str]:
    """Unicode word tokenizer (replaces nltk.word_tokenize; no punkt data)."""
    return _WORD_RE.findall(text)


def expand_contractions(text: str) -> str:
    for k, v in _CONTRACTIONS.items():
        text = text.replace(k, v)
    return text


@dataclass(frozen=True)
class PipelineSpec:
    name: str
    lowercase: bool = True
    strip_html: bool = False
    strip_urls: bool = False
    expand_contractions: bool = False
    strip_numbers: bool = False
    ascii_only: bool = False            # the "regex" variant's latent ar/ko bug
    stopword_scope: str = "union"       # "union" | "per-lang"
    normalizer: str = "best"            # "best" | "porter" | "none"
    bigrams: bool = True                # fr/de/es/it 2-gram augmentation
    ko_particles: bool = True           # emit stripped ko particles as tokens


PIPELINES: Dict[str, PipelineSpec] = {
    "best": PipelineSpec("best"),
    "porter": PipelineSpec(
        "porter", stopword_scope="per-lang", normalizer="porter", bigrams=False
    ),
    "regex": PipelineSpec(
        "regex", ascii_only=True, stopword_scope="per-lang", normalizer="best",
        bigrams=False,
    ),
    "rich": PipelineSpec(
        "rich", strip_html=True, strip_urls=True, expand_contractions=True,
        strip_numbers=True, stopword_scope="per-lang", normalizer="best",
        bigrams=False,
    ),
}


class Preprocessor:
    """Configurable multilingual text → token-list pipeline."""

    def __init__(self, pipeline: str = "best", langs: Sequence[str] = ("ar", "de", "en", "es", "fr", "it", "ko")):
        self.spec = PIPELINES[pipeline] if isinstance(pipeline, str) else pipeline
        self.langs = tuple(langs)
        self._union = stopword_union([l for l in self.langs if l not in ("ar", "ko")] or ["en"])
        self._normalizers = {l: normalizer_for(l, self.spec.normalizer) for l in self.langs}
        # memoized per-language normalization cache: stem/lemma calls dominate
        # host preprocessing cost (the reference's slowest stage; it pickles
        # the result to avoid re-running, SURVEY.md §7 "host/device split")
        self._memo: Dict[str, Dict[str, str]] = {l: {} for l in self.langs}

    # -- token-level ---------------------------------------------------------

    def _stopwords(self, lang: str):
        if self.spec.stopword_scope == "union" and lang not in ("ar", "ko"):
            return self._union
        return stopwords_for(lang)

    def _normalize(self, lang: str, tok: str) -> str:
        memo = self._memo.setdefault(lang, {})
        out = memo.get(tok)
        if out is None:
            fn = self._normalizers.get(lang) or normalizer_for(lang, self.spec.normalizer)
            out = fn(tok)
            if len(memo) < 2_000_000:
                memo[tok] = out
        return out

    # -- text-level ----------------------------------------------------------

    def tokens(self, text: str, lang: str) -> List[str]:
        spec = self.spec
        if spec.lowercase:
            text = text.lower()
        if spec.strip_html:
            text = _HTML_RE.sub(" ", text)
        if spec.strip_urls:
            text = _URL_RE.sub(" ", text)
        if spec.expand_contractions:
            text = expand_contractions(text)
        if spec.strip_numbers:
            text = _NUM_RE.sub(" ", text)
        if spec.ascii_only:
            text = _ASCII_ALNUM_RE.sub(" ", text)

        if lang == "ko":
            toks = tokenize_korean(text, emit_particles=spec.ko_particles)
        elif lang == "ar":
            toks = word_tokenize(normalize_arabic(text))
        else:
            toks = word_tokenize(text.translate(_PUNCT_TABLE))

        sw = self._stopwords(lang)
        minlen = 1 if lang in ("ko", "ar") else 2
        toks = [t for t in toks if len(t) >= minlen and t not in sw]
        toks = [self._normalize(lang, t) for t in toks]
        toks = [t for t in toks if t]

        if spec.bigrams and lang in BIGRAM_LANGS and len(toks) > 1:
            # joined 2-grams appended after unigrams (bm25_ranking.ipynb:106)
            toks = toks + [f"{a}_{b}" for a, b in zip(toks, toks[1:])]
        return toks

    def __call__(self, text: str, lang: str) -> List[str]:
        return self.tokens(text, lang)


_DEFAULT: Optional[Preprocessor] = None


def _default() -> Preprocessor:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Preprocessor("best")
    return _DEFAULT


def preprocess_text(text: str, lang: str, pipeline: str = "best") -> List[str]:
    if pipeline == "best":
        return _default()(text, lang)
    return Preprocessor(pipeline)(text, lang)


def preprocess_texts(
    texts: Iterable[str], langs: Iterable[str], pipeline: str = "best", workers: int = 0
) -> List[List[str]]:
    """Batch preprocessing.

    ``workers>0`` fans out across processes (the reference shards the corpus
    over ``multiprocessing`` pools, team_run1.py:102-109); the default stays
    in-process, where the memoized normalizers usually win for this corpus.
    """
    pp = _default() if pipeline == "best" else Preprocessor(pipeline)
    texts = list(texts)
    langs = list(langs)
    if workers and len(texts) > 1000:
        import multiprocessing as mp

        with mp.Pool(workers) as pool:
            return pool.starmap(pp, zip(texts, langs), chunksize=256)
    return [pp(t, l) for t, l in zip(texts, langs)]
