"""The reference's text layer: the "best" preprocessing pipeline of the DIS
Project 1 reference (bm25_ranking.ipynb), written plainly.

Per language: lowercase; Latin scripts have ASCII punctuation replaced by
spaces and split into word runs, Arabic is stripped of diacritics and
tatweel with its letter variants unified, Korean word runs are split into
Hangul stems and their detached particles; tokens in the stopword set (a
union over en/fr/de/es/it for the Latin scripts) or shorter than the
minimum (2 Latin, 1 ar/ko) are dropped; English is lemmatized with WordNet
morphy's noun rules, fr/de/es/it are Snowball-stemmed; fr/de/es/it append
the joined 2-grams of consecutive tokens after the unigrams.

``encode_corpus`` turns one language's documents into integer term ids
with numpy (every distinct raw word is normalised once), ``encode_corpora``
does so for several languages in worker processes, and
``encode_queries`` maps query texts onto the same ids.  Nothing here
imports the program.
"""

from __future__ import annotations

import re
import string
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from tdrbench.reference.snowball import (FrenchStemmer, GermanStemmer,
                                         ItalianStemmer, SpanishStemmer)
from tdrbench.reference.stopwords import stopword_union, stopwords_for

BIGRAM_LANGS = frozenset({"fr", "de", "es", "it"})
_PUNCT = str.maketrans({c: " " for c in string.punctuation})
_WORD = re.compile(r"\w+")
_AR_DIACRITICS = re.compile(
    "[\u0610-\u061a\u064b-\u065f\u0670\u06d6-\u06dc\u06df-\u06e8"
    "\u06ea-\u06ed\u0640]")
_AR_MAP = str.maketrans({"أ": "ا", "إ": "ا", "آ": "ا", "ة": "ه", "ى": "ي",
                         "ؤ": "و", "ئ": "ي"})
_HANGUL = re.compile(r"[가-힯ᄀ-ᇿ㄰-㆏]+")
_KO_PARTICLES = sorted(set("""
은 는 이 가 을 를 의 에 와 과 도 만 께 에서 에게 한테 으로 로 보다 부터 까지 마다
처럼 같이 조차 마저 밖에 에게서 한테서 으로서 으로써 로서 로써 이나 나 이라도 라도
이며 며 하고 이랑 랑 에다 에다가 이든 든 이든지 든지 입니다 습니다 합니다 했습니다
됩니다 있습니다 없습니다 이다 하다 했다 한다 하는 하게 하지 하여 해서 하며 하면 되다
되는 되어 됐다 된다 된 이었다 였다 이에요 예요 이죠 죠 네요 어요 아요 습니까 합니까
인가 일까 에요""".split()), key=len, reverse=True)

# WordNet morphy's noun detachment rules, longest first
_NOUN_RULES = [("ches", "ch"), ("shes", "sh"), ("xes", "x"), ("zes", "z"),
               ("ses", "s"), ("ies", "y"), ("men", "man"), ("s", "")]
_KEEP_S = frozenset(
    "is was has this thus its his hers ours yours theirs as us bus gas lens "
    "news series species analysis basis crisis physics mathematics politics "
    "economics classics athletics statistics".split())
_STEMMERS = {"fr": FrenchStemmer, "de": GermanStemmer, "it": ItalianStemmer,
             "es": SpanishStemmer}


def lemmatize_en(word: str) -> str:
    if word.endswith("men") and len(word) > 3:
        return word[:-3] + "man"
    if (len(word) <= 2 or not word.endswith("s") or word in _KEEP_S
            or word.endswith("ss") or word.endswith("us")):
        return word
    for suf, rep in _NOUN_RULES:
        if word.endswith(suf) and len(word) - len(suf) + len(rep) >= 2:
            return word[: -len(suf)] + rep
    return word


def _ko_split(run: str) -> List[str]:
    """A word run → its Hangul stems with their detached particles and its
    other parts, in order."""
    out, pos = [], 0
    for m in _HANGUL.finditer(run):
        if m.start() > pos:
            out.append(run[pos:m.start()])
        tok = m.group()
        for suf in _KO_PARTICLES:
            if tok.endswith(suf) and len(tok) > len(suf):
                out += [tok[: -len(suf)], suf]
                break
        else:
            out.append(tok)
        pos = m.end()
    if pos < len(run):
        out.append(run[pos:])
    return out


class Analyzer:
    """One language's word → tokens mapping, memoised per raw word run."""

    def __init__(self, lang: str):
        self.lang = lang
        latin = lang not in ("ar", "ko")
        self.stop = (stopword_union(("en", "fr", "de", "es", "it")) if latin
                     else stopwords_for(lang))
        self.min_len = 2 if latin else 1
        if lang == "en":
            self.norm = lemmatize_en
        elif lang in _STEMMERS:
            self.norm = _STEMMERS[lang]().stem
        else:
            self.norm = lambda w: w
        self.memo: Dict[str, Tuple[str, ...]] = {}

    def normal(self, text: str) -> str:
        """The text lowercased, Arabic normalised, Latin punctuation blanked."""
        text = text.lower()
        if self.lang == "ar":
            return _AR_DIACRITICS.sub("", text).translate(_AR_MAP)
        return text if self.lang == "ko" else text.translate(_PUNCT)

    def runs(self, text: str) -> List[str]:
        """The word runs of a text (before the stopword filter)."""
        return _WORD.findall(self.normal(text))

    def word(self, run: str) -> Tuple[str, ...]:
        out = self.memo.get(run)
        if out is None:
            parts = _ko_split(run) if self.lang == "ko" else [run]
            keep = [self.norm(p) for p in parts
                    if len(p) >= self.min_len and p not in self.stop]
            out = self.memo[run] = tuple(t for t in keep if t)
        return out

    def tokens(self, text: str) -> List[str]:
        toks = [t for r in self.runs(text) for t in self.word(r)]
        if self.lang in BIGRAM_LANGS and len(toks) > 1:
            toks = toks + [f"{a}_{b}" for a, b in zip(toks, toks[1:])]
        return toks


@dataclass
class LangIndex:
    """One language's documents as terms: unigram ids for the distinct
    normalised words, then ids for the distinct 2-grams; per (doc, term)
    counts; document lengths in tokens, 2-grams included."""

    lang: str
    unigram: Dict[str, int]
    bigram: np.ndarray              # sorted left * n_unigram + right keys;
                                    # the j-th is term n_unigram + j
    n_terms: int
    doc: np.ndarray                 # (nnz,) int64, sorted by (doc, term)
    term: np.ndarray                # (nnz,) int64
    tf: np.ndarray                  # (nnz,) float64
    doc_len: np.ndarray             # (n_docs,) float64
    n_docs: int


_SEP = "\x01"          # ends a document: no word character, no punctuation


def _encode_piece(an: Analyzer, texts: Sequence[str]):
    """A run of documents → (its distinct normalised words, in the order
    of their ids, the kept tokens as those ids, each document's count of
    kept tokens).  The documents are scanned as one string, each ended by
    ``_SEP``, and split at white space (never a word character, so the
    word runs of a piece are those of the text); each distinct piece is
    analysed once."""
    words: Dict[str, int] = {}
    pieces = an.normal(f" {_SEP} ".join(texts) + f" {_SEP}").split()
    first = {p: i for i, p in enumerate(set(pieces))}
    ids = [tuple(words.setdefault(t, len(words)) for r in _WORD.findall(p)
                 for t in an.word(r)) if p != _SEP else (-2,)
           for p in first]
    lens = np.array([len(t) or 1 for t in ids], np.int64)
    flat = np.array([i for t in ids for i in (t or (-1,))], np.int64)
    at = np.concatenate([[0], np.cumsum(lens)])
    which = np.fromiter(map(first.__getitem__, pieces), np.int64, len(pieces))
    n = lens[which]
    stream = flat[np.repeat(at[which], n) + np.arange(int(n.sum()))
                  - np.repeat(np.cumsum(n) - n, n)]
    ends = stream == -2
    doc = np.cumsum(ends) - ends                  # the document of each id
    keep = stream >= 0
    return (list(words), stream[keep].astype(np.int32),
            np.bincount(doc[keep], minlength=int(ends.sum())))


def _cuts(texts: Sequence[str], chars: int) -> List[Tuple[int, int]]:
    """Runs of documents of about ``chars`` characters each."""
    if not len(texts):
        return []
    ends = np.cumsum(np.fromiter(map(len, texts), np.int64, len(texts)))
    stops = np.searchsorted(ends, np.arange(chars, ends[-1], chars),
                            side="right")
    bounds = [0] + sorted(set(stops.tolist()) - {0, len(texts)}) + [len(texts)]
    return list(zip(bounds[:-1], bounds[1:]))


def _merge(parts) -> Tuple[Dict[str, int], np.ndarray, np.ndarray]:
    """The pieces of one language, in order → its word ids, its stream of
    term ids and each document's offset into it."""
    unigram: Dict[str, int] = {}
    streams, lens = [], []
    for words, stream, n in parts:
        remap = np.fromiter((unigram.setdefault(w, len(unigram))
                             for w in words), np.int64, len(words))
        streams.append(remap[stream] if len(words) else
                       stream.astype(np.int64))
        lens.append(n)
    offsets = np.concatenate([[0], np.cumsum(np.concatenate(lens))])
    return unigram, np.concatenate(streams), offsets


def encode_corpus(texts: Sequence[str], lang: str,
                  chars: int = 1 << 25) -> LangIndex:
    """One language's documents → ``LangIndex``, in this process, a run
    of about ``chars`` characters at a time."""
    an = Analyzer(lang)
    unigram, stream, offsets = _merge(
        _encode_piece(an, texts[a:b]) for a, b in _cuts(texts, chars))
    return _count(lang, unigram, stream, offsets)


# what the workers read: set before they are forked, so that they share it
_WORK: Dict[str, Sequence[str]] = {}


def _piece_job(job):
    lang, a, b = job
    return _encode_piece(Analyzer(lang), _WORK[lang][a:b])


def _count_job(job):
    lang, n_uni, stream, offsets = job
    return _count(lang, range(n_uni), stream.astype(np.int64), offsets)


def encode_corpora(texts: Dict[str, Sequence[str]], workers: int,
                   chars: int = 1 << 23) -> Dict[str, LangIndex]:
    """``encode_corpus`` of each language, the work spread over
    ``workers`` processes forked from this one (they read the texts in
    place, only run Python and numpy, and have all ended on return): runs
    of about ``chars`` characters analysed apart, then each language's
    counts."""
    import multiprocessing

    langs = sorted(texts, key=lambda l: -sum(map(len, texts[l])))
    jobs = [(lang, a, b) for lang in langs for a, b in _cuts(texts[lang],
                                                              chars)]
    _WORK.update(texts)
    try:
        pool = multiprocessing.get_context("fork").Pool(workers)
    finally:
        _WORK.clear()
    try:
        pieces = pool.map(_piece_job, jobs, chunksize=1)
        by: Dict[str, list] = {}
        for (lang, _, _), piece in zip(jobs, pieces):
            by.setdefault(lang, []).append(piece)
        del pieces
        merged = {lang: _merge(by.pop(lang)) for lang in langs}
        counted = pool.map(_count_job, [
            (lang, len(u), st.astype(np.int32), off)
            for lang, (u, st, off) in merged.items()], chunksize=1)
    finally:
        pool.close()
        pool.join()
    out = {}
    for ix in counted:
        ix.unigram = merged[ix.lang][0]
        out[ix.lang] = ix
    return out


def _count(lang, unigram, stream, offsets) -> LangIndex:
    """(doc, term) counts, 2-grams and lengths of one language's stream;
    ``unigram`` the word ids (anything with a length, in a worker)."""
    n_docs = len(offsets) - 1
    n_uni = max(len(unigram), 1)
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), np.diff(offsets))
    terms, docs = [stream], [doc_of]
    bigram = np.zeros(0, np.int64)
    if lang in BIGRAM_LANGS and len(stream) > 1:
        same = doc_of[:-1] == doc_of[1:]
        key = stream[:-1][same] * n_uni + stream[1:][same]
        uniq, inv = np.unique(key, return_inverse=True)
        bigram = uniq
        terms.append(len(unigram) + inv.reshape(-1))
        docs.append(doc_of[:-1][same])
    term = np.concatenate(terms)
    doc = np.concatenate(docs)
    doc_len = np.bincount(doc, minlength=n_docs).astype(np.float64)
    n_terms = len(unigram) + len(bigram)
    packed, tf = np.unique(doc * max(n_terms, 1) + term, return_counts=True)
    return LangIndex(lang, unigram, bigram, n_terms,
                     packed // max(n_terms, 1), packed % max(n_terms, 1),
                     tf.astype(np.float64), doc_len, n_docs)


def encode_queries(texts: Sequence[str], ix: LangIndex,
                   max_terms: int = 64) -> List[List[int]]:
    """Each query's distinct known term ids, unigrams then 2-grams in order
    of first appearance, at most ``max_terms``."""
    an = Analyzer(ix.lang)
    n_uni = max(len(ix.unigram), 1)
    out = []
    for text in texts:
        toks = [t for r in an.runs(text) for t in an.word(r)]
        ids = [ix.unigram.get(t, -1) for t in toks]
        if ix.lang in BIGRAM_LANGS and len(toks) > 1:
            keys = np.array([a * n_uni + b if a >= 0 and b >= 0 else -1
                             for a, b in zip(ids, ids[1:])], np.int64)
            j = np.searchsorted(ix.bigram, keys)
            hit = (keys >= 0) & (j < len(ix.bigram))
            hit[hit] = ix.bigram[j[hit]] == keys[hit]
            ids += np.where(hit, n_uni + j, -1).tolist()
        seen: List[int] = []
        for i in ids:
            if i >= 0 and i not in seen:
                seen.append(i)
        out.append(seen[:max_terms])
    return out

