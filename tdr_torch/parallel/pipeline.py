"""Pipeline parallelism across devices (from ``tdr/parallel/pipeline.py``).

The two-stage cascade (``tdr_torch.rank.cascade``) with each stage's index
on its own device: the candidate index on ``stage1_device``, the re-rank
index on ``stage2_device``.  Query batches flow through both stages,

    t:      stage1(b0) | stage1(b1) | stage1(b2) | ...
                        stage2(b0)  | stage2(b1) | stage2(b2)

Each stage's work is queued on its own device, and the only cross-stage
dependency is batch i's (B, C) candidate set, copied with
``non_blocking=True``; every batch's result comes back in one packed copy
at the end.  On two cards stage 2 of batch i can run while stage 1 scores
batch i+1; on one card the stages run in sequence.  (Each stage reads one
overflow flag a batch, as ``score_and_topk_fused`` does, which syncs its
own device.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np
import torch

from tdr_torch.models.sparse import SparseModel
from tdr_torch.ops.score import score_and_topk_fused
from tdr_torch.parallel.mesh import _copy
from tdr_torch.rank.cascade import rerank_pairs_topk, tokenize_queries
from tdr_torch.rank.router import _gather_results
from tdr_torch.text.preprocess import Preprocessor


@dataclass
class PipelinedCascade:
    """Two-stage cascade with each stage pinned to its own device.

    ``cand_model`` and ``rank_model`` index the same doc partition (same
    docid order); their indexes are placed on ``stage1_device`` and
    ``stage2_device`` when the cascade is made."""

    cand_model: SparseModel
    rank_model: SparseModel
    stage1_device: object
    stage2_device: object
    candidates: int = 200
    query_batch: int = 128
    preprocessor: Preprocessor = field(
        default_factory=lambda: Preprocessor("best"))

    def __post_init__(self) -> None:
        if self.cand_model.docids != self.rank_model.docids:
            raise ValueError("cascade stages must index the same doc "
                             "partition")
        self.stage1_device = torch.device(self.stage1_device)
        self.stage2_device = torch.device(self.stage2_device)
        self._idx1 = self.cand_model.index.to(self.stage1_device)
        self._idx2 = self.rank_model.index.to(self.stage2_device)

    def retrieve(self, queries: Sequence[str], lang: str, k: int = 10
                 ) -> List[List[str]]:
        """Top-k docids per query: every batch is dispatched through both
        stages before any result is read."""
        toks = tokenize_queries(self.preprocessor, queries, lang)
        C = min(self.candidates, self.cand_model.index.n_docs)
        k_eff = min(k, C)
        B = self.query_batch
        d1, d2 = self.stage1_device, self.stage2_device

        pending = []
        for s in range(0, len(toks), B):
            chunk = toks[s:s + B]
            n = len(chunk)
            if n < B:
                chunk = chunk + [[]] * (B - n)
            # each stage encodes against its own vocab
            qids1, qw1 = self.cand_model.encode_query_tokens(chunk)
            qids2, qw2 = self.rank_model.encode_query_tokens(chunk)
            # stage 1 on its device: the wide top-C candidate scan
            v1, rows = score_and_topk_fused(
                self._idx1, _copy(qids1, d1), _copy(qw1, d1), top_k=C,
                tail_budget=self.cand_model.tail_budget)
            # only the (B, C) candidates cross to stage 2
            vals, out_rows = rerank_pairs_topk(
                self._idx2, _copy(qids2, d2), _copy(qw2, d2),
                _copy(rows, d2), _copy(v1, d2), k_eff,
                tail_budget=self.rank_model.tail_budget)
            pending.append((s, n, vals, out_rows))

        results: List[List[str]] = [[] for _ in toks]
        if pending:
            vals_all, rows_all = _gather_results([p[2] for p in pending],
                                                 [p[3] for p in pending])
            docids = self.rank_model.docids
            for i, (s, n, _, _) in enumerate(pending):
                for j in range(n):
                    results[s + j] = [docids[r] for r, v in zip(
                        rows_all[i][j], vals_all[i][j]) if np.isfinite(v)]
        return results
