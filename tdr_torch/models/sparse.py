"""Sparse retrieval models for the port: per-language BM25 and TF-IDF
cosine (``tdr/models/sparse.py``).

A model bundles vocab + sparse score-row index + docid table for one
document partition.  The head engine follows ``tdr``'s choice with the
platform check replaced by the shape gate alone: the row gather for
batches of at most ``small_q_threshold`` queries, the fused block-max
kernel when ``fused_head_available`` passes (exact and exact_compact
modes), else the full-head product.  Tail-bearing indexes always compact
their tails with the ``tail_compact`` kernel, whatever ``tail_engine``
says; ``use_fused_topk=False`` scores through the scatter path instead.
No environment variable chooses an engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tdr_torch.index.build import SparseIndex, build_index, build_tfidf_index
from tdr_torch.ops.fused_head import fused_head_available
from tdr_torch.ops.score import (score_and_topk, score_and_topk_fused,
                                 score_candidates_fused)
from tdr_torch.text.vocab import Vocab, build_vocab, encode_docs, encode_queries
from tdr_torch.utils.config import BM25Config, IndexConfig
from tdr_torch.utils.device import DeviceLike
from tdr_torch.utils.trace import annotate


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
    use_fused_topk: bool = True       # False: the scatter path, no kernel
    # tdr's tail engine choice, accepted with any of its values: the port's
    # one tail engine is the tail_compact kernel (its plain version on CPU)
    tail_engine: str = "auto"
    # "exact" | "exact_compact" (widened head candidates, tiered merge) |
    # "approx" (the same tiers; tdr's approx_max_k is exact off the TPU)
    topk_mode: str = "exact"
    small_q_threshold: int = 8        # Q <= this: per-term row-gather head
    # host-side OOV query-term repair by trigram vocabulary matching
    spell_correct: bool = False
    # RM3 pseudo-relevance feedback: mine the first pass's top prf_docs
    # documents for prf_terms expansion terms (each in at least
    # prf_min_docs of them) and re-score once with beta-scaled weights
    prf: bool = False
    prf_docs: int = 3         # = feedback.DEFAULT_FEEDBACK_DOCS
    prf_terms: int = 5        # = feedback.DEFAULT_EXPAND_TERMS
    prf_beta: float = 0.3     # = feedback.DEFAULT_BETA
    prf_min_docs: int = 2     # = feedback.DEFAULT_MIN_DOCS

    @property
    def device(self) -> torch.device:
        return self.index.device

    def _repairer(self):
        """The trigram repairer over this partition's unigram vocabulary,
        built on first use and kept on the instance (bigram "a_b" terms are
        left out: a typo is never repaired into a phrase)."""
        rep = getattr(self, "_repairer_cache", None)
        if rep is None:
            from tdr_torch.text.spell import TrigramRepairer

            df_all = np.asarray(self.vocab.df, np.float32)
            terms, dfs = [], []
            for t, i in self.vocab.term_to_id.items():
                if "_" not in t:
                    terms.append(t)
                    dfs.append(df_all[i] if i < df_all.shape[0] else 1.0)
            rep = TrigramRepairer(terms, np.asarray(dfs, np.float32))
            self._repairer_cache = rep
        return rep

    # -- query encoding ------------------------------------------------------

    def encode_query_tokens_np(self, token_lists: Sequence[Sequence[str]]
                               ) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side encoding: (qids (Q, T) int32, qw (Q, T) f32) numpy."""
        with annotate("tdr_torch.sparse.encode"):
            if self.spell_correct:
                token_lists = self._repairer().repair_token_lists(
                    token_lists, self.vocab.term_to_id)
            qids, qw = encode_queries(token_lists, self.vocab,
                                      self.max_query_terms)
            if self.query_weight == "idf":
                # cosine query vector = idf per present term
                idf = self.index.stats.idf.cpu().numpy()
                qw = np.where(qw > 0,
                              idf[np.clip(qids, 0, idf.shape[0] - 1)] * qw,
                              0.0).astype(np.float32)
            return qids, qw

    def encode_query_tokens(self, token_lists: Sequence[Sequence[str]]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(qids (Q, T) int32, qw (Q, T) f32) on the model's device.  Each
        copy from pageable host memory waits for the device's stream."""
        out = []
        for a in self.encode_query_tokens_np(token_lists):
            with annotate("tdr_torch.sync.queries_h2d"):
                out.append(torch.from_numpy(a).to(self.device))
        return tuple(out)

    # -- scoring -------------------------------------------------------------

    def head_engine(self, n_queries: int, k: int) -> str:
        """The row gather for small batches; the fused block-max kernel on a
        full-vocab head that passes its shape gate in the exact and
        exact_compact modes; else the full-head product."""
        if 0 < n_queries <= self.small_q_threshold:
            return "gather"
        if (self.topk_mode in ("exact", "exact_compact")
                and fused_head_available(self.index, k)):
            return "fused"
        return "matmul"

    def topk_encoded_async(self, qids: torch.Tensor, qw: torch.Tensor,
                           k: int = 10):
        """Scoring from encoded query tensors on the model's device; returns
        device tensors (vals (Q, k), rows (Q, k)).  With ``prf`` this runs
        the two-pass feedback loop, with no host read between the passes."""
        with annotate("tdr_torch.sparse.score"):
            if self.prf:
                qids, qw = self._prf_expand(qids, qw)
            return self._score_encoded(qids, qw, k)

    def _score_encoded(self, qids: torch.Tensor, qw: torch.Tensor, k: int):
        """One scoring pass (never expands)."""
        if self.use_fused_topk:
            return score_and_topk_fused(
                self.index, qids, qw, top_k=k, tail_budget=self.tail_budget,
                tail_engine=self.tail_engine, topk_mode=self.topk_mode,
                head_engine=self.head_engine(qids.shape[0], k))
        return score_and_topk(self.index, qids, qw, top_k=k)

    def _doc_major(self):
        """The doc-major mirror for feedback mining, kept on the index so
        that model copies made with ``dataclasses.replace`` share it."""
        dmi = getattr(self.index, "_doc_major_cache", None)
        if dmi is None:
            from tdr_torch.rank.feedback import build_doc_major

            dmi = build_doc_major(self.index)
            object.__setattr__(self.index, "_doc_major_cache", dmi)
        return dmi

    def _prf_expand(self, qids: torch.Tensor, qw: torch.Tensor):
        """First pass at k = prf_docs, then RM3 mining: the widened
        (Q, T+E) query tensors for the second pass."""
        from tdr_torch.rank.feedback import prf_expand

        fb_vals, fb_rows = self._score_encoded(qids, qw, self.prf_docs)
        return prf_expand(self._doc_major(), self.index.vocab_size,
                          qids, qw, fb_vals, fb_rows,
                          n_expand=self.prf_terms, n_feedback=self.prf_docs,
                          beta=self.prf_beta, min_docs=self.prf_min_docs)

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

    def retrieve_tokens(self, token_lists: Sequence[Sequence[str]],
                        k: int = 10) -> List[List[str]]:
        """Top-k docid lists; -inf pad entries (k > corpus size) dropped."""
        vals, rows = self.topk_tokens(token_lists, k)
        return [[self.docids[r] for r, v in zip(qrow, qvals) if np.isfinite(v)]
                for qrow, qvals in zip(rows, vals)]

    def score_candidates_tokens(self, token_lists: Sequence[Sequence[str]],
                                cand_rows: np.ndarray) -> np.ndarray:
        """(Q, C) scores for explicit candidate rows through
        ``score_candidates_fused`` (head product + the compaction kernel)."""
        qids, qw = self.encode_query_tokens(token_lists)
        cand = torch.as_tensor(np.asarray(cand_rows), device=self.device)
        return score_candidates_fused(self.index, qids, qw, cand,
                                      tail_budget=self.tail_budget,
                                      tail_engine=self.tail_engine
                                      ).cpu().numpy()


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
