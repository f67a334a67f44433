# Copied from tdr/text/fast.py; only the imports are rewritten.
"""Fast corpus encoding: native tokenizer + vectorized normalize/bigram/count.

End-to-end replacement for ``preprocess_texts`` + ``build_vocab`` +
``encode_docs`` on the corpus side, with identical semantics to the "best"
pipeline (bm25_ranking.ipynb:84-110):

1. C++ tokenizer (tdr.native): UTF-8 scan, lowercase, script-aware split,
   Arabic normalization, Korean particle detachment, stopword filter,
   interning to raw int32 ids.  One call per language so each language sees
   its own stopword set, exactly like the Python path.
2. Morphological normalization (en lemma / fr,de,es,it Snowball) applied to
   the UNIQUE raw vocabulary only, then broadcast over the token stream as
   an int32 id map.
3. Bigram augmentation for fr/de/es/it as vectorized pair-key uniquing.
4. (doc, term) counting via one sort-free np.unique over packed keys.

Produces a ``Vocab`` whose term strings match the Python pipeline, so query
encoding and golden formulas are unchanged.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from tdr_torch.text.ko import _SUFFIXES
from tdr_torch.text.lemmatize import normalizer_for
from tdr_torch.text.stopwords import stopwords_for, stopword_union
from tdr_torch.text.preprocess import BIGRAM_LANGS
from tdr_torch.text.vocab import Vocab
from tdr_torch.utils.trace import log

_LANG_MODE = {"ar": "a", "ko": "k"}
_NORM_MEMO: Dict[tuple, Dict[str, str]] = {}
_NORM_MEMO_CAP = 2_000_000        # same bound as Preprocessor._normalize


def _native_tokenize_lang(texts, lang, pipeline="best"):
    from tdr_torch import native

    mode = _LANG_MODE.get(lang, "l")
    if pipeline == "best" and mode == "l":
        sw = stopword_union(("en", "fr", "de", "es", "it"))
    else:
        sw = stopwords_for(lang)
    return native.tokenize_batch(
        texts, [mode] * len(texts), sorted(sw), _SUFFIXES,
        emit_particles=True, min_len_latin=2,
    )


def fast_encode_corpus(
    texts: Sequence[str],
    langs: Sequence[str],
    pipeline: str = "best",
    min_df: int = 1,
) -> Tuple[Vocab, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """→ (vocab, doc_ids, term_ids, tfs, doc_lens) for a single-language
    partition (all ``langs`` entries must be equal — the router partitions
    by language first)."""
    lang = langs[0]
    assert all(l == lang for l in langs), "fast_encode_corpus is per-language"

    raw_ids, doc_offsets, raw_vocab = _native_tokenize_lang(list(texts), lang, pipeline)

    # --- normalize unique raw terms, build stemmed vocab ------------------
    normalize = normalizer_for(lang, "best" if pipeline == "best" else "none")
    stem_strings: Dict[str, int] = {}
    raw_to_stem = np.zeros(max(len(raw_vocab), 1), np.int32)
    for rid, term in enumerate(raw_vocab):
        # Universal lowercase net: the C++ tokenizer lowercases ASCII /
        # Latin-1 / Latin-Ext-A / Greek / Cyrillic inline; any script it
        # cannot map (e.g. Latin Ext-B) is caught here on the UNIQUE vocab
        # with exact str.lower semantics, then merged by id.
        s = normalize(term.lower())
        sid = stem_strings.setdefault(s, len(stem_strings))
        raw_to_stem[rid] = sid
    n_unigram = len(stem_strings)

    stream = raw_to_stem[raw_ids] if len(raw_ids) else np.zeros(0, np.int32)
    n_docs = len(texts)

    # --- (doc, term) counting: one native pass when available -------------
    # The numpy tail below re-reads the token stream ~30x through 64-bit
    # temporaries (repeat/pack/np.unique/bincounts) — 56 s of the 170 s
    # full-fidelity build on the slow-memory bench host (round-4 profile).
    # countdocs.cc emits the same COO/doc_lens/df (np.unique order, bigram
    # ids in sorted-pair-key order) in a single pass; parity is pinned in
    # tests/test_native.py.
    bigrams = lang in BIGRAM_LANGS and pipeline == "best"
    from tdr_torch import native

    # available() already swallows NativeUnavailable and returns a bool
    if native.available() and len(stream) > 0:
        doc_ids, term_ids, tfs, doc_lens, df, pkeys = native.count_docs(
            stream, doc_offsets, n_unigram, bigrams)
        pair_to_id = (
            {int(k): n_unigram + i for i, k in enumerate(pkeys)}
            if bigrams and len(pkeys) else None)
        vocab_size = n_unigram + len(pkeys)
        return _finish_vocab(stem_strings, pair_to_id, vocab_size,
                             n_unigram, df, min_df, n_docs,
                             doc_ids, term_ids, tfs, doc_lens)

    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64),
                       np.diff(doc_offsets)) if len(raw_ids) else np.zeros(0, np.int64)

    # --- bigram augmentation (joined 2-grams appended per doc) ------------
    if bigrams and len(stream) > 1:
        left, right = stream[:-1].astype(np.int64), stream[1:].astype(np.int64)
        same_doc = doc_of[:-1] == doc_of[1:]
        pair_key = (left << 32) | right
        pair_key = pair_key[same_doc]
        pair_doc = doc_of[:-1][same_doc]
        uniq_pairs, pair_ids = np.unique(pair_key, return_inverse=True)
        # bigram vocabulary stored as packed id pairs — no string
        # materialization for the (often millions of) bigram entries
        pair_to_id = {int(k): n_unigram + i for i, k in enumerate(uniq_pairs)}
        bigram_terms = (pair_ids + n_unigram).astype(np.int64)
        all_terms = np.concatenate([stream.astype(np.int64), bigram_terms])
        all_docs = np.concatenate([doc_of, pair_doc])
    else:
        pair_to_id = None
        all_terms = stream.astype(np.int64)
        all_docs = doc_of

    vocab_size = len(stem_strings) + (len(pair_to_id) if pair_to_id else 0)

    # --- doc lengths (all tokens incl. bigrams) and (doc, term) counts ----
    doc_lens = np.bincount(all_docs, minlength=n_docs).astype(np.int32)
    packed = (all_docs << 32) | all_terms
    uniq, counts = np.unique(packed, return_counts=True)
    doc_ids = (uniq >> 32).astype(np.int32)
    term_ids = (uniq & 0xFFFFFFFF).astype(np.int32)
    tfs = counts.astype(np.float32)
    df = np.bincount(term_ids, minlength=vocab_size).astype(np.int32)
    return _finish_vocab(stem_strings, pair_to_id, vocab_size, n_unigram,
                         df, min_df, n_docs, doc_ids, term_ids, tfs,
                         doc_lens)


def _finish_vocab(stem_strings, pair_to_id, vocab_size, n_unigram, df,
                  min_df, n_docs, doc_ids, term_ids, tfs, doc_lens):
    """Shared encode tail: optional min_df pruning + Vocab construction
    (identical for the native-count and numpy-count paths)."""
    df = np.asarray(df, np.int32)
    if min_df > 1:
        keep = df >= min_df
        remap = np.cumsum(keep).astype(np.int32) - 1
        sel = keep[term_ids]
        # python path counts only in-vocab tokens into dl; match it
        pruned_tf = np.zeros(n_docs, np.int64)
        np.add.at(pruned_tf, doc_ids[~sel], tfs[~sel].astype(np.int64))
        doc_lens = (doc_lens - pruned_tf).astype(np.int32)
        doc_ids, term_ids, tfs = doc_ids[sel], remap[term_ids[sel]], tfs[sel]
        # surviving bigrams get materialized strings (their component
        # unigrams may themselves be pruned, so packed pairs can't be kept)
        id_to_str = [""] * n_unigram
        for s, i in stem_strings.items():
            id_to_str[i] = s
        new_terms: Dict[str, int] = {}
        for s, i in stem_strings.items():
            if keep[i]:
                new_terms[s] = int(remap[i])
        if pair_to_id:
            for key, i in pair_to_id.items():
                if keep[i]:
                    new_terms[f"{id_to_str[key >> 32]}_{id_to_str[key & 0xFFFFFFFF]}"] = int(remap[i])
        stem_strings = new_terms
        pair_to_id = None
        df = df[keep]

    vocab = Vocab(stem_strings, df, n_docs, pair_to_id=pair_to_id)
    return vocab, doc_ids, term_ids, tfs, doc_lens


def fast_tokenize_texts(
    texts: Sequence[str], lang: str, pipeline: str = "best",
) -> list:
    """Token lists via the native tokenizer + unique-vocab normalization —
    the query-side analogue of ``fast_encode_corpus``.  Semantics match
    ``Preprocessor(pipeline)`` for the "best" pipeline (same C++ scan,
    stopword set, normalizer and joined-bigram augmentation; parity-tested
    in tests/test_native.py) at a fraction of the per-text Python cost —
    query preprocessing was ~35% of warm end-to-end retrieval."""
    raw_ids, doc_offsets, raw_vocab = _native_tokenize_lang(
        list(texts), lang, pipeline)
    normalize = normalizer_for(lang, "best" if pipeline == "best" else "none")
    # memoized across calls: morphy/snowball normalization of the unique
    # raw vocabulary dominates this function otherwise (same reason
    # Preprocessor keeps a per-language memo)
    memo = _NORM_MEMO.setdefault((lang, pipeline), {})
    norm = [None] * len(raw_vocab)
    for i, t in enumerate(raw_vocab):
        s = memo.get(t)
        if s is None:
            s = normalize(t.lower())
            if len(memo) < _NORM_MEMO_CAP:   # bound long-lived serving RSS
                memo[t] = s
        norm[i] = s
    bigrams = lang in BIGRAM_LANGS and pipeline == "best"
    out = []
    for i in range(len(texts)):
        toks = [norm[r] for r in raw_ids[doc_offsets[i]:doc_offsets[i + 1]]]
        toks = [t for t in toks if t]
        if bigrams and len(toks) > 1:
            toks = toks + [f"{a}_{b}" for a, b in zip(toks, toks[1:])]
        out.append(toks)
    return out


def fast_available() -> bool:
    from tdr_torch import native

    return native.available()
