"""Cascade retrieval, candidate generation → re-ranking: the port of
``tdr/rank/cascade.py``.

Cosine → BM25: the top-C candidates of the first stage
(``score_and_topk_fused``), re-scored by the second stage's index
(``score_candidates_fused``: the head product gathered at the candidates
plus the ``tail_compact`` kernel's slots matched against them; or the
binary-search ``score_pairs``), then the final top-k — with no host read
between the stages, and every batch's result brought back in one copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tdr_torch.models.sparse import SparseModel
from tdr_torch.ops.score import (NEG_INF, score_and_topk_fused,
                                 score_candidates_fused, score_pairs)
from tdr_torch.ops.topk import fast_topk
from tdr_torch.rank.router import _gather_results
from tdr_torch.text.preprocess import Preprocessor


def cascade_score_topk(cand_index, rank_index, qids1: torch.Tensor,
                       qw1: torch.Tensor, qids2: torch.Tensor,
                       qw2: torch.Tensor, C: int, k: int, tail_budget: int,
                       cand_engine: str = "xla", rank_engine: str = "xla"):
    """Both stages, dispatched back to back: fused top-C candidates →
    candidate re-score → final top-k.  (vals (Q, min(k, C)), rows).
    ``cand_engine`` and ``rank_engine`` are each stage's ``tail_engine``
    (see ``score_and_topk_fused``)."""
    vals1, cand_rows = score_and_topk_fused(
        cand_index, qids1, qw1, top_k=C, tail_budget=tail_budget,
        tail_engine=cand_engine)
    return rerank_pairs_topk(rank_index, qids2, qw2, cand_rows, vals1,
                             min(k, C), tail_budget=tail_budget,
                             tail_engine=rank_engine)


def rerank_pairs_topk(rank_index, qids2: torch.Tensor, qw2: torch.Tensor,
                      cand_rows: torch.Tensor, vals1: torch.Tensor, k: int,
                      tail_budget: int = 2048, tail_engine: str = "xla",
                      exact_pairs: bool = False):
    """Stage 2 alone: re-rank explicit candidate rows and take the top-k.
    ``score_candidates_fused`` (with ``tail_engine``) by default;
    ``exact_pairs=True`` takes the f32-exact binary-search ``score_pairs``."""
    if exact_pairs:
        re_scores = score_pairs(rank_index, qids2, qw2, cand_rows)
    else:
        re_scores = score_candidates_fused(rank_index, qids2, qw2, cand_rows,
                                           tail_budget=tail_budget,
                                           tail_engine=tail_engine)
    re_scores = torch.where(torch.isfinite(vals1), re_scores,
                            torch.full((), NEG_INF, device=re_scores.device))
    vals, sel = fast_topk(re_scores, k)
    return vals, cand_rows.gather(1, sel)


def tokenize_queries(preprocessor: Preprocessor, texts: Sequence[str],
                     lang: str) -> List[List[str]]:
    """Query tokens: the "best" pipeline through the C++ tokenizer when it
    builds, else ``preprocessor`` in Python (the same tokens)."""
    if preprocessor.spec.name == "best":
        from tdr_torch.text.fast import fast_available

        if fast_available():
            from tdr_torch.text.fast import fast_tokenize_texts

            return fast_tokenize_texts(list(texts), lang)
    return [preprocessor(t, lang) for t in texts]


@dataclass
class CascadeRetriever:
    """Two-stage retrieve: candidate_models[lang] → rerank_models[lang]."""

    candidate_models: Dict[str, SparseModel]
    rerank_models: Dict[str, SparseModel]
    candidates: int = 200
    preprocessor: Preprocessor = field(default_factory=lambda: Preprocessor("best"))
    query_batch: int = 128
    default_lang: str = "en"

    def _group(self, langs: Sequence[str]) -> Dict[str, List[int]]:
        groups: Dict[str, List[int]] = {}
        for i, lang in enumerate(langs):
            key = lang if lang in self.candidate_models else self.default_lang
            groups.setdefault(key, []).append(i)
        return groups

    def _tokenize(self, queries: Sequence[str], q_idx: Sequence[int],
                  lang: str) -> List[List[str]]:
        return tokenize_queries(self.preprocessor,
                                [queries[i] for i in q_idx], lang)

    def retrieve(self, queries: Sequence[str], langs: Sequence[str],
                 k: int = 10) -> List[List[str]]:
        results: List[Optional[List[str]]] = [None] * len(queries)
        pending = []   # (rank_model, sel, vals, rows, n_chunk)
        for lang, q_idx in self._group(langs).items():
            cand_m = self.candidate_models[lang]
            rank_m = self.rerank_models[lang]
            if cand_m.docids != rank_m.docids:
                raise ValueError("cascade stages must index the same doc "
                                 "partition")
            toks = self._tokenize(queries, q_idx, lang)
            C = min(self.candidates, cand_m.index.n_docs)
            for s in range(0, len(q_idx), self.query_batch):
                sel = q_idx[s:s + self.query_batch]
                chunk = toks[s:s + self.query_batch]
                n_chunk = len(chunk)
                if n_chunk < self.query_batch:
                    chunk = chunk + [[]] * (self.query_batch - n_chunk)
                qids1, qw1 = cand_m.encode_query_tokens(chunk)
                qids2, qw2 = rank_m.encode_query_tokens(chunk)
                vals, rows = cascade_score_topk(
                    cand_m.index, rank_m.index, qids1, qw1, qids2, qw2,
                    C=C, k=min(k, C), tail_budget=cand_m.tail_budget)
                pending.append((rank_m, sel, vals, rows, n_chunk))
        if pending:
            vals_all, rows_all = _gather_results([p[2] for p in pending],
                                                 [p[3] for p in pending])
            for i, (rank_m, sel, _, _, n) in enumerate(pending):
                for j, rr, vv in zip(sel, rows_all[i][:n], vals_all[i][:n]):
                    results[j] = [rank_m.docids[r]
                                  for r, v in zip(rr, vv) if np.isfinite(v)]
        return [r if r is not None else [] for r in results]
