# Copied from tdr/eval/metrics.py; only the imports are rewritten.
"""L5 evaluation: Recall@k, MRR@k, per-language breakdown.

Mirrors the reference's evaluators: evaluate_recall_at_k
(bm25_ranking.ipynb:329-364 — hit if the positive doc appears in the top-k),
MRR@{1,5,10} + Recall@{1,5,10} (team_run1.py:296-325), and the per-language
recall breakdown (text_preprocessing_and_embedding_setup.py:535-562).
Returns a structured metrics dict instead of prints.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence


def _mean_positional_discount(
    retrieved: Sequence[Sequence[str]], positives: Sequence[str], k: int,
    discount: Callable[[int], float],
) -> float:
    """Mean of ``discount(rank)`` over queries (0 when the positive is not
    in the top-k; rank is 0-based) — the shape shared by MRR and nDCG."""
    if not retrieved:
        return 0.0
    total = 0.0
    for r, p in zip(retrieved, positives):
        try:
            total += discount(list(r[:k]).index(p))
        except ValueError:
            pass
    return total / len(retrieved)


def recall_at_k(
    retrieved: Sequence[Sequence[str]], positives: Sequence[str], k: int = 10
) -> float:
    """Fraction of queries whose positive doc is in the top-k."""
    if not retrieved:
        return 0.0
    hits = sum(1 for r, p in zip(retrieved, positives) if p in r[:k])
    return hits / len(retrieved)


def mrr_at_k(
    retrieved: Sequence[Sequence[str]], positives: Sequence[str], k: int = 10
) -> float:
    """Mean reciprocal rank of the positive doc within the top-k."""
    return _mean_positional_discount(retrieved, positives, k,
                                     lambda r: 1.0 / (r + 1))


def ndcg_at_k(
    retrieved: Sequence[Sequence[str]], positives: Sequence[str], k: int = 10
) -> float:
    """nDCG@k for the single-relevant-document case (the dataset has one
    positive per query, SURVEY §0): DCG = 1/log2(rank+1) if the positive
    is at `rank` (1-based) in the top-k, else 0; IDCG = 1, so nDCG is the
    mean positional discount — strictly between recall@k (position-blind)
    and MRR@k (steeper 1/rank discount).  Beyond the reference's metric
    set; standard IR reporting."""
    return _mean_positional_discount(retrieved, positives, k,
                                     lambda r: 1.0 / math.log2(r + 2))


def macro_f1(
    retrieved: Sequence[Sequence[str]], positives: Sequence[str]
) -> float:
    """Macro-averaged F1 of the top-1 prediction vs the positive doc.

    The reference's FAISS path scores sklearn ``f1_score(average="macro")``
    over top-1 docids (faiss_based_ANN_Implementation.py:301-303): each
    distinct docid is a class; per-class F1 is computed from the top-1
    predictions and averaged unweighted over all classes present in either
    labels or predictions (sklearn's label set)."""
    if not retrieved:
        return 0.0
    y_pred = [r[0] if len(r) else "" for r in retrieved]
    y_true = list(positives)
    tp: Dict[str, int] = {}
    fp: Dict[str, int] = {}
    fn: Dict[str, int] = {}
    for t, p in zip(y_true, y_pred):
        if t == p:
            tp[t] = tp.get(t, 0) + 1
        else:
            fp[p] = fp.get(p, 0) + 1
            fn[t] = fn.get(t, 0) + 1
    classes = set(y_true) | set(y_pred)
    classes.discard("")
    f1s = []
    for c in sorted(classes):
        denom = 2 * tp.get(c, 0) + fp.get(c, 0) + fn.get(c, 0)
        f1s.append(2 * tp.get(c, 0) / denom if denom else 0.0)
    return sum(f1s) / len(f1s) if f1s else 0.0


def evaluate_retrieval(
    retrieved: Sequence[Sequence[str]],
    positives: Sequence[str],
    langs: Optional[Sequence[str]] = None,
    ks: Sequence[int] = (1, 5, 10),
) -> Dict[str, object]:
    """Full report: recall@k / mrr@k for each k, plus per-language recall@max(k)."""
    report: Dict[str, object] = {"n_queries": len(retrieved)}
    for k in ks:
        report[f"recall@{k}"] = recall_at_k(retrieved, positives, k)
        report[f"mrr@{k}"] = mrr_at_k(retrieved, positives, k)
    if ks:
        report[f"ndcg@{max(ks)}"] = ndcg_at_k(retrieved, positives, max(ks))
    report["macro_f1@1"] = macro_f1(retrieved, positives)
    if langs is not None:
        kmax = max(ks)
        by_lang: Dict[str, List[int]] = {}
        for i, l in enumerate(langs):
            by_lang.setdefault(l, []).append(i)
        report["per_language"] = {
            l: {
                "n": len(idx),
                f"recall@{kmax}": recall_at_k(
                    [retrieved[i] for i in idx], [positives[i] for i in idx], kmax
                ),
            }
            for l, idx in sorted(by_lang.items())
        }
    return report
