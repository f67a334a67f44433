# Copied from tdr/text/vocab.py; only the imports are rewritten.
"""Vocabulary: term → int32 id mapping feeding device arrays.

The reference keeps string-keyed dicts everywhere (term_freqs / idf /
inverted_index, e.g. cosine_similarity_bm25_reranking.py:129-182).  A TPU
framework needs integer ids and static shapes: the vocab is built once per
language on the host, docs/queries are encoded to int32 arrays, and every
downstream structure (CSR index, IDF table, dense head) is indexed by id.

Supports df-threshold pruning (the reference's frequency_threshold knob,
ranking_with_bm25.py:29,131) — pruning happens at build so pruned terms never
get ids and encode to -1 (masked on device).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Vocab:
    term_to_id: Dict[str, int]
    df: np.ndarray          # (V,) int32 document frequency per term id
    n_docs: int
    # bigram terms stored as packed unigram-id pairs ((a << 32) | b) instead
    # of materialized "a_b" strings — the fast corpus encoder defers string
    # construction for the (potentially millions of) bigram vocabulary
    # entries; queries resolve "a_b" forms through this table
    pair_to_id: Optional[Dict[int, int]] = None

    @property
    def size(self) -> int:
        return len(self.term_to_id) + (len(self.pair_to_id) if self.pair_to_id else 0)

    def _encode_bigram(self, term: str) -> int:
        # try each "_" split point; unigram terms may themselves contain "_"
        for cut in range(len(term)):
            if term[cut] != "_":
                continue
            a = self.term_to_id.get(term[:cut])
            b = self.term_to_id.get(term[cut + 1:])
            if a is not None and b is not None:
                i = self.pair_to_id.get((a << 32) | b)
                if i is not None:
                    return i
        return -1

    def encode_term(self, term: str) -> int:
        i = self.term_to_id.get(term)
        if i is not None:
            return i
        if self.pair_to_id and "_" in term:
            return self._encode_bigram(term)
        return -1

    def encode(self, tokens: Sequence[str]) -> List[int]:
        out = []
        for t in tokens:
            i = self.encode_term(t)
            if i >= 0:
                out.append(i)
        return out

    def id_to_term(self) -> List[str]:
        out = [""] * self.size
        for t, i in self.term_to_id.items():
            out[i] = t
        if self.pair_to_id:
            for key, i in self.pair_to_id.items():
                out[i] = f"{out[key >> 32]}_{out[key & 0xFFFFFFFF]}"
        return out


def build_vocab(token_lists: Iterable[Sequence[str]], min_df: int = 1) -> Vocab:
    """One pass over tokenized docs → term ids ordered by first appearance,
    plus df counts.  min_df>1 prunes the long tail before ids are assigned."""
    df_counter: Counter = Counter()
    n_docs = 0
    for toks in token_lists:
        n_docs += 1
        df_counter.update(set(toks))
    term_to_id: Dict[str, int] = {}
    dfs: List[int] = []
    for term, df in df_counter.items():
        if df >= min_df:
            term_to_id[term] = len(term_to_id)
            dfs.append(df)
    return Vocab(term_to_id, np.asarray(dfs, dtype=np.int32), n_docs)


def encode_docs(
    token_lists: Sequence[Sequence[str]], vocab: Vocab
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tokenized docs → COO term-frequency arrays.

    Returns (doc_ids, term_ids, tfs, doc_lens): one COO entry per unique
    (doc, term) pair; doc_lens counts ALL in-vocab tokens (the dl used by
    BM25).  This replaces the reference's per-doc Counter dict loop
    (bm25_ranking.ipynb:178-190) with flat arrays ready for device segment
    ops.
    """
    doc_ids: List[int] = []
    term_ids: List[int] = []
    tfs: List[int] = []
    doc_lens = np.zeros(len(token_lists), dtype=np.int32)
    t2i = vocab.term_to_id
    for d, toks in enumerate(token_lists):
        c = Counter()
        n = 0
        for t in toks:
            i = t2i.get(t)
            if i is not None:
                c[i] += 1
                n += 1
        doc_lens[d] = n
        for i, tf in c.items():
            doc_ids.append(d)
            term_ids.append(i)
            tfs.append(tf)
    return (
        np.asarray(doc_ids, dtype=np.int32),
        np.asarray(term_ids, dtype=np.int32),
        np.asarray(tfs, dtype=np.float32),
        doc_lens,
    )


def encode_queries(
    query_token_lists: Sequence[Sequence[str]],
    vocab: Vocab,
    max_terms: int = 64,
    unique: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Queries → (Q, T) padded int32 term-id matrix + (Q, T) float32 weights.

    ``unique=True`` keeps each term once (the winning scorer iterates
    ``set(query)``, bm25_ranking.ipynb:195); weights are the in-query term
    counts when ``unique=False``.  Padding id is 0 with weight 0 (masked by
    weight, so id 0 stays a valid vocab id).

    Engine note (measured twice, conclusions opposite): round 2 replaced
    the per-token dict walk with one batched ``np.unique`` over the flat
    token stream; at the real query profile (~6 tokens/query, 256-query
    chunks) that is an 8x PESSIMIZATION — np.unique sorts object strings
    and the per-query dedupe uniques dominate (39 vs 5 ms per 2000 en
    queries; 74 ms of the 242 ms full-scale retrieve wall).  A flat dict
    walk is O(total tokens) hash lookups with tiny constants, so this is
    the plain loop again, on purpose.  First-seen order, first
    ``max_terms`` kept — identical outputs to both prior engines.
    """
    Q = len(query_token_lists)
    ids = np.zeros((Q, max_terms), dtype=np.int32)
    w = np.zeros((Q, max_terms), dtype=np.float32)
    enc = vocab.encode_term
    for q, toks in enumerate(query_token_lists):
        if unique:
            seen = set()
            col = 0
            for t in toks:
                i = enc(t)
                if i >= 0 and i not in seen:
                    seen.add(i)
                    ids[q, col] = i
                    w[q, col] = 1.0
                    col += 1
                    if col >= max_terms:
                        break
        else:
            counts: dict = {}            # insertion order == first seen
            for t in toks:
                i = enc(t)
                if i >= 0:
                    counts[i] = counts.get(i, 0) + 1
            for col, (i, c) in enumerate(counts.items()):
                if col >= max_terms:
                    break
                ids[q, col] = i
                w[q, col] = c
    return ids, w
