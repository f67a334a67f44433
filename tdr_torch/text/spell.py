# Copied from tdr/text/spell.py (verbatim).
"""OOV query-term repair by character-trigram vocabulary matching.

The hard eval corrupts 15% of query terms with typos (tdr.data.synthetic
hard mode, mirroring real query noise); a corrupted term that misses the
vocabulary contributes NOTHING to the score — the reference simply drops
it (bm25_ranking.ipynb:191-205 skips unknown terms).  This module maps an
out-of-vocabulary token to its closest vocabulary term by character
trigram overlap (Jaccard), the standard fuzzy-term trick of production
search engines (Elasticsearch/Lucene ngram fuzzy matching).

Design for the TPU serving path: everything here is HOST-side and touches
only OOV tokens (in-vocabulary tokens pay one dict probe).  The trigram
inverted index over the vocabulary is built lazily on first use (numpy
CSR: one concatenated postings array + offsets), repairs are memoized, and
candidate scoring per token is two `np.bincount`-style vectorized passes —
no Python loop over the vocabulary.

Opt-in: `SparseModel.spell_correct = True` (or `--spell-correct` on the
CLI eval/retrieve paths).  Off by default so the headline bench measures
the same pipeline as the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# repair acceptance: at least this trigram-Jaccard similarity, and the
# candidate length within +-2 characters of the query token (cheap guard
# against short-token false positives)
MIN_JACCARD = 0.34
MAX_LEN_DELTA = 2
# memo bound: long-running serve processes see unbounded distinct OOV
# tokens (typo traffic is heavy-tailed); evict the oldest half at the cap
MEMO_CAP = 65536


def _trigrams(term: str) -> List[str]:
    s = f"^{term}$"
    if len(s) < 3:
        return [s]
    return [s[i:i + 3] for i in range(len(s) - 2)]


class TrigramRepairer:
    """Trigram inverted index over a term vocabulary + OOV repair."""

    def __init__(self, terms: Sequence[str], df: Optional[np.ndarray] = None):
        self.terms = list(terms)
        n = len(self.terms)
        self.term_len = np.fromiter((len(t) for t in self.terms),
                                    np.int32, count=n)
        self.df = (np.asarray(df, np.float32)[:n] if df is not None
                   else np.ones(n, np.float32))
        tri_ids: Dict[str, int] = {}
        term_rows: List[int] = []
        term_tris: List[int] = []
        n_tri_per_term = np.zeros(n, np.int32)
        for row, t in enumerate(self.terms):
            tris = set(_trigrams(t))
            n_tri_per_term[row] = len(tris)
            for g in tris:
                term_tris.append(tri_ids.setdefault(g, len(tri_ids)))
                term_rows.append(row)
        self.tri_ids = tri_ids
        self.n_tri_per_term = n_tri_per_term
        # CSR: trigram id -> term rows
        tri = np.asarray(term_tris, np.int64)
        rows = np.asarray(term_rows, np.int32)
        order = np.argsort(tri, kind="stable")
        self.postings = rows[order]
        counts = np.bincount(tri, minlength=len(tri_ids))
        self.offsets = np.zeros(len(tri_ids) + 1, np.int64)
        np.cumsum(counts, out=self.offsets[1:])
        self._memo: Dict[str, Optional[str]] = {}

    def repair(self, token: str) -> Optional[str]:
        """Closest vocabulary term by trigram Jaccard, or None."""
        hit = self._memo.get(token, False)
        if hit is not False:
            return hit
        tris = set(_trigrams(token))
        ids = [self.tri_ids[g] for g in tris if g in self.tri_ids]
        out: Optional[str] = None
        if ids:
            cand = np.concatenate([
                self.postings[self.offsets[i]:self.offsets[i + 1]]
                for i in ids])
            rows, inter = np.unique(cand, return_counts=True)
            keep = np.abs(self.term_len[rows] - len(token)) <= MAX_LEN_DELTA
            rows, inter = rows[keep], inter[keep]
            if rows.size:
                union = len(tris) + self.n_tri_per_term[rows] - inter
                jac = inter / union
                if jac.max() >= MIN_JACCARD:
                    best = jac >= jac.max() - 1e-9
                    # among maximal-Jaccard candidates prefer the most
                    # frequent term (typos of common words are the common
                    # case)
                    cands = rows[best]
                    out = self.terms[int(cands[np.argmax(self.df[cands])])]
        if len(self._memo) >= MEMO_CAP:
            # dicts iterate in insertion order: drop the oldest half
            for k in list(self._memo)[: MEMO_CAP // 2]:
                del self._memo[k]
        self._memo[token] = out
        return out

    def repair_token_lists(
        self, token_lists: Sequence[Sequence[str]], known: Dict[str, int]
    ) -> List[List[str]]:
        """Replace OOV tokens (not in ``known``) by their repairs; tokens
        with no acceptable repair are kept verbatim (they encode to
        nothing, exactly as before)."""
        out = []
        for toks in token_lists:
            fixed = None
            for i, t in enumerate(toks):
                if t in known or "_" in t:   # unigrams only; bigrams follow
                    continue
                r = self.repair(t)
                if r is not None and r != t:
                    if fixed is None:
                        fixed = list(toks)
                    fixed[i] = r
            out.append(fixed if fixed is not None else list(toks))
        return out
