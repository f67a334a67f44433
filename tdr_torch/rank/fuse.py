# Copied from tdr/rank/fuse.py (verbatim).
"""Rank fusion across retrieval engines.

tdr ships several engines over the same corpus (BM25, TF-IDF cosine, the
dense retriever, cascades); production systems routinely ensemble them.
Reciprocal Rank Fusion (Cormack et al., SIGIR'09) is the standard
score-free combiner: ``rrf(d) = Σ_engines 1 / (k + rank_e(d))`` — it
needs no score calibration across engines (BM25 scores and cosine
similarities live on different scales), degrades gracefully when an
engine misses a document, and is a pure host-side merge over the tiny
top-k lists the engines already return.

The reference has no ensembling — its runs pick ONE engine per submission
(team_run1.py vs bm25_ranking.ipynb are alternatives, never combined).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

RRF_K = 60   # the paper's constant; flat optimum in practice


def rrf_fuse(rankings: Sequence[Sequence[Sequence[str]]],
             k: int = 10, rrf_k: int = RRF_K,
             weights: Optional[Sequence[float]] = None) -> List[List[str]]:
    """Fuse per-engine rankings into one top-k list per query.

    ``rankings[e][q]`` is engine ``e``'s ranked docid list for query ``q``
    (as returned by ``LanguageRouter.retrieve`` / ``retrieve_tokens``).
    ``weights`` optionally scales each engine's contribution (default 1).
    Ties break toward the engine-0 ordering (stable sort over insertion
    order)."""
    if not rankings:
        return []
    n_q = len(rankings[0])
    for r in rankings:
        if len(r) != n_q:
            raise ValueError("all engines must rank the same query list")
    if weights is None:
        weights = [1.0] * len(rankings)
    if len(weights) != len(rankings):
        raise ValueError("one weight per engine")
    out: List[List[str]] = []
    for q in range(n_q):
        score: Dict[str, float] = {}
        for w, engine in zip(weights, rankings):
            for rank, d in enumerate(engine[q]):
                score[d] = score.get(d, 0.0) + w / (rrf_k + rank + 1)
        fused = sorted(score, key=lambda d: -score[d])
        out.append(fused[:k])
    return out
