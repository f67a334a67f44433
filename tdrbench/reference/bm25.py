"""The reference's Okapi BM25, in float64 torch: the statistics rebuilt from
the reference's own term counts (``text.LangIndex``), then every document's
score for a block of queries as one product.

    idf(t)   = ln(1 + (N - df(t) + 0.5) / (df(t) + 0.5))
    w(t, d)  = idf(t) * tf * (k1 + 1) / (tf + k1 * (1 - b + s * dl(d) / avgdl))
    score(q, d) = sum of w(t, d) over the distinct known terms t of q

with s = b where the configuration scales dl/avgdl by b, else 1 (the DIS
reference's winning variant, bm25_ranking.ipynb).  Nothing here imports the
program.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from tdrbench.reference.text import LangIndex


class BM25Reference:
    def __init__(self, ix: LangIndex, k1: float, b: float,
                 dl_scaled_by_b: bool, idf_variant: str, device):
        if idf_variant != "bm25":
            raise ValueError(f"the reference implements idf 'bm25', not "
                             f"{idf_variant!r}")
        self.n_docs = ix.n_docs
        self.device = torch.device(device)
        df = np.bincount(ix.term, minlength=ix.n_terms).astype(np.float64)
        idf = np.log1p((ix.n_docs - df + 0.5) / (df + 0.5))
        avgdl = ix.doc_len.mean() if ix.n_docs else 1.0
        norm = (b if dl_scaled_by_b else 1.0) * ix.doc_len / avgdl
        self.post_w = idf[ix.term] * ix.tf * (k1 + 1.0) / (
            ix.tf + k1 * (1.0 - b + norm[ix.doc]))
        self.post_term, self.post_doc = ix.term, ix.doc

    def scores(self, queries: Sequence[List[int]]) -> torch.Tensor:
        """(len(queries), n_docs) float64 scores on the reference's device."""
        terms = np.array(sorted({t for q in queries for t in q}), np.int64)
        col = {t: j for j, t in enumerate(terms.tolist())}
        W = torch.zeros((max(len(terms), 1), self.n_docs), dtype=torch.float64,
                        device=self.device)
        if len(terms):
            sel = np.flatnonzero(np.isin(self.post_term, terms))
            row = np.searchsorted(terms, self.post_term[sel])
            W[torch.as_tensor(row, device=self.device),
              torch.as_tensor(self.post_doc[sel], device=self.device)] = \
                torch.as_tensor(self.post_w[sel], device=self.device)
        Q = torch.zeros((len(queries), W.shape[0]), dtype=torch.float64)
        for i, q in enumerate(queries):
            for t in q:
                Q[i, col[t]] = 1.0
        return Q.to(self.device) @ W


def block_size(n_docs: int, n_terms: int, budget_bytes: float = 8e9) -> int:
    """Queries a block of ``scores`` may hold so that its term rows and its
    score rows stay within ``budget_bytes`` of float64."""
    return max(1, int((budget_bytes / 8 - n_terms * n_docs) // max(n_docs, 1)))


def kth_and_at(ref: torch.Tensor, rows: np.ndarray, k: int):
    """For a block's reference scores: each query's k-th best score, and
    the score of each listed (query, rank) document (rows < 0, answers
    naming no document of this language, read NaN)."""
    kk = min(k, ref.shape[1])
    kth = torch.topk(ref, kk, dim=1).values[:, kk - 1].cpu().numpy()
    r = torch.as_tensor(np.clip(rows, 0, ref.shape[1] - 1), device=ref.device)
    at = torch.gather(ref, 1, r.long()).cpu().numpy()
    at[rows < 0] = math.nan
    return kth, at
