"""Sparse retrieval models for the port: per-language BM25 and TF-IDF
cosine (``tdr/models/sparse.py``).

A model bundles vocab + sparse score-row index + docid table for one
document partition.  The head engine follows ``tdr``'s choice with the
platform check replaced by the index's device: the row gather for batches
of at most ``small_q_threshold`` queries, the fused block-max kernel when
the shape gate of ``fused_head_available`` passes, else the full-head
product.  Tail-bearing indexes always compact their tails with the
``tail_compact`` kernel.  No environment variable chooses an engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tdr_torch.index.build import SparseIndex, build_index, build_tfidf_index
from tdr_torch.ops.fused_head import fused_head_available
from tdr_torch.ops.score import score_and_topk_fused
from tdr_torch.text.vocab import Vocab, build_vocab, encode_docs, encode_queries
from tdr_torch.utils.config import BM25Config, IndexConfig
from tdr_torch.utils.device import DeviceLike


@dataclass
class SparseModel:
    """Common machinery for BM25 / TF-IDF models over one doc partition."""

    vocab: Vocab
    index: SparseIndex
    docids: List[str]
    lang: str = "en"
    max_query_terms: int = 64
    query_weight: str = "unit"        # "unit" (BM25) | "idf" (cosine)
    tail_budget: int = 1024           # fused-topk tail compaction budget
    topk_mode: str = "exact"          # only "exact" is ported
    small_q_threshold: int = 8        # Q <= this: per-term row-gather head
    spell_correct: bool = False       # not ported: raises
    prf: bool = False                 # not ported: raises

    @property
    def device(self) -> torch.device:
        return self.index.device

    def _check_ported(self) -> None:
        if self.spell_correct:
            raise NotImplementedError("spell_correct is not ported yet")
        if self.prf:
            raise NotImplementedError("prf is not ported yet")

    # -- query encoding ------------------------------------------------------

    def encode_query_tokens(self, token_lists: Sequence[Sequence[str]]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(qids (Q, T) int32, qw (Q, T) f32) on the model's device."""
        self._check_ported()
        qids, qw = encode_queries(token_lists, self.vocab, self.max_query_terms)
        if self.query_weight == "idf":
            # cosine query vector = idf per present term
            idf = self.index.stats.idf.cpu().numpy()
            qw = np.where(qw > 0, idf[np.clip(qids, 0, idf.shape[0] - 1)] * qw,
                          0.0).astype(np.float32)
        return (torch.from_numpy(qids).to(self.device),
                torch.from_numpy(qw).to(self.device))

    # -- scoring -------------------------------------------------------------

    def head_engine(self, n_queries: int, k: int) -> str:
        if 0 < n_queries <= self.small_q_threshold:
            return "gather"
        if fused_head_available(self.index, k):
            return "fused"
        return "matmul"

    def topk_encoded_async(self, qids: torch.Tensor, qw: torch.Tensor,
                           k: int = 10):
        """Scoring from encoded query tensors on the model's device; returns
        device tensors (vals (Q, k), rows (Q, k))."""
        self._check_ported()
        return score_and_topk_fused(
            self.index, qids, qw, top_k=k, tail_budget=self.tail_budget,
            topk_mode=self.topk_mode,
            head_engine=self.head_engine(qids.shape[0], k))

    def topk_tokens_async(self, token_lists, k: int = 10,
                          pad_to: Optional[int] = None):
        """Dispatch scoring without reading results back: (vals, rows) on
        the device plus the real query count.  ``pad_to`` pads the query
        axis to a fixed batch size."""
        n = len(token_lists)
        if pad_to is not None and n < pad_to:
            token_lists = list(token_lists) + [[]] * (pad_to - n)
        qids, qw = self.encode_query_tokens(token_lists)
        vals, rows = self.topk_encoded_async(qids, qw, k)
        return vals, rows, n

    def topk_tokens(self, token_lists: Sequence[Sequence[str]], k: int = 10,
                    pad_to: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (Q, k), local doc rows (Q, k)) as host arrays."""
        vals, rows, n = self.topk_tokens_async(token_lists, k, pad_to)
        return vals.cpu().numpy()[:n], rows.cpu().numpy()[:n]


@dataclass
class BM25Model(SparseModel):
    """Okapi BM25."""

    @classmethod
    def from_coo(cls, vocab: Vocab, coo, docids: Sequence[str],
                 lang: str = "en", bm25: BM25Config = BM25Config(),
                 index_cfg: IndexConfig = IndexConfig(),
                 max_query_terms: int = 64, head_size: Optional[int] = None,
                 device: DeviceLike = None) -> "BM25Model":
        index = build_index(*coo, vocab.size, bm25=bm25, index_cfg=index_cfg,
                            weight_kind="bm25", head_size=head_size,
                            df_host=vocab.df, device=device)
        return cls(vocab=vocab, index=index, docids=list(docids), lang=lang,
                   max_query_terms=max_query_terms, query_weight="unit")

    @classmethod
    def build(cls, doc_token_lists: Sequence[Sequence[str]],
              docids: Sequence[str], lang: str = "en",
              bm25: BM25Config = BM25Config(),
              index_cfg: IndexConfig = IndexConfig(),
              max_query_terms: int = 64, head_size: Optional[int] = None,
              device: DeviceLike = None) -> "BM25Model":
        vocab = build_vocab(doc_token_lists, min_df=index_cfg.min_df)
        coo = encode_docs(doc_token_lists, vocab)
        return cls.from_coo(vocab, coo, docids, lang=lang, bm25=bm25,
                            index_cfg=index_cfg,
                            max_query_terms=max_query_terms,
                            head_size=head_size, device=device)


@dataclass
class TfidfCosineModel(SparseModel):
    """TF-IDF + cosine similarity: L2-normalized tf·idf doc rows and an
    idf-weighted query vector."""

    @classmethod
    def from_coo(cls, vocab: Vocab, coo, docids: Sequence[str],
                 lang: str = "en", index_cfg: IndexConfig = IndexConfig(),
                 max_query_terms: int = 64, head_size: Optional[int] = None,
                 device: DeviceLike = None) -> "TfidfCosineModel":
        index = build_tfidf_index(*coo, vocab.size, index_cfg=index_cfg,
                                  head_size=head_size, df_host=vocab.df,
                                  device=device)
        return cls(vocab=vocab, index=index, docids=list(docids), lang=lang,
                   max_query_terms=max_query_terms, query_weight="idf")

    @classmethod
    def build(cls, doc_token_lists: Sequence[Sequence[str]],
              docids: Sequence[str], lang: str = "en",
              index_cfg: IndexConfig = IndexConfig(),
              max_query_terms: int = 64, head_size: Optional[int] = None,
              device: DeviceLike = None) -> "TfidfCosineModel":
        vocab = build_vocab(doc_token_lists, min_df=index_cfg.min_df)
        coo = encode_docs(doc_token_lists, vocab)
        return cls.from_coo(vocab, coo, docids, lang=lang,
                            index_cfg=index_cfg,
                            max_query_terms=max_query_terms,
                            head_size=head_size, device=device)
