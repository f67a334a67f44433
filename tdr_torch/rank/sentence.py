# Source: tdr/rank/sentence.py.  The host code (sentence splitting,
# candidate_union, the fusion helpers and the dedupe) is a copy of its;
# stage 1 and the stage-2 similarities run on the device.
"""Sentence-level retrieval + dense re-rank cascade: the port of
``tdr/rank/sentence.py``.

Re-implements the reference's third pipeline family (team_run1.py /
cosine_similarity_lm_reranking..py):

* documents split into sentences on '.' with ids ``{docid}_{idx}``
  (team_run1.py:45-46, :88-99)
* sentence-level BM25 index (the same sparse score-row engine — sentences
  are just short documents)
* boolean candidate-union generation: union of postings for the query's
  terms, capped at MAX_CANDIDATES (team_run1.py:152-169)
* dense re-rank: encode top sentences + query with the dense encoder,
  cosine top-k, then dedupe sentence hits back to documents
  (team_run1.py:274-295 ``get_original_docid`` + dedupe)

On the card: stage 1 is the sparse engine over the sentence index (its
tail compaction is the ``tail_compact`` kernel), every query chunk
dispatched before any result is read.  The corpus-wide sentence embeddings
stay on the device; each chunk's (n, M, D) candidate gather and its cosine
product run there too, and the scores, rows and similarities of all chunks
come back in one copy.  Fusion, the evidence sums, the stable sort and the
dedupe are host numpy, as in ``tdr``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tdr_torch.models.sparse import BM25Model
from tdr_torch.ops.precision import ieee_f32
from tdr_torch.text.preprocess import Preprocessor
from tdr_torch.utils.config import BM25Config, IndexConfig
from tdr_torch.utils.device import DeviceLike


def split_into_sentences(text: str) -> List[str]:
    """Reference semantics: split on '.', drop empties (team_run1.py:45-46)."""
    return [s.strip() for s in text.split(".") if s.strip()]


def sentence_id(docid: str, idx: int) -> str:
    return f"{docid}_{idx}"


def get_original_docid(sid: str) -> str:
    """``{docid}_{idx}`` → docid (team_run1.py:126-127)."""
    return sid.rsplit("_", 1)[0]


def explode_corpus(
    docids: Sequence[str], texts: Sequence[str]
) -> Tuple[List[str], List[str]]:
    """Docs → (sentence ids, sentence texts)."""
    sids: List[str] = []
    stexts: List[str] = []
    for d, t in zip(docids, texts):
        for i, s in enumerate(split_into_sentences(t)):
            sids.append(sentence_id(d, i))
            stexts.append(s)
    return sids, stexts


@dataclass
class SentenceBM25:
    """Per-language sentence-level BM25 built on the sparse score-row engine.

    Keeps the original sentence texts by row; ``precompute_embeddings``
    additionally stores one dense embedding per sentence on the encoder's
    device (the reference embeds ALL sentences once up front,
    team_run1.py:225-239) plus a host row→document mapping."""

    model: BM25Model
    texts: List[str]
    embeddings: Optional[torch.Tensor] = None    # (S, D) f32, on the device
    doc_of_row: Optional[np.ndarray] = None      # (S,) int32 into doc_table
    doc_table: Optional[List[str]] = None

    def precompute_embeddings(self, dense, batch: int = 256) -> None:
        """Embed every sentence once (idempotent; lazy on first retrieval)."""
        if self.embeddings is None:
            self.embeddings = dense.encode_queries(self.texts, batch=batch)
        if self.doc_of_row is None:
            table: Dict[str, int] = {}
            d_of = np.zeros(len(self.model.docids), np.int32)
            for r, sid in enumerate(self.model.docids):
                d_of[r] = table.setdefault(get_original_docid(sid), len(table))
            self.doc_of_row = d_of
            self.doc_table = list(table)

    @classmethod
    def build(
        cls, docids: Sequence[str], texts: Sequence[str], lang: str,
        preprocessor: Optional[Preprocessor] = None,
        bm25: BM25Config = BM25Config(dl_scaled_by_b=True, idf_variant="bm25_plus1"),
        index_cfg: IndexConfig = IndexConfig(),
        fast: Optional[bool] = None,
        device: DeviceLike = None,
    ) -> "SentenceBM25":
        # the sentence pipeline uses the textbook b-scaled denominator and
        # +1-smoothed idf (team_run1.py:187-193)
        sids, stexts = explode_corpus(docids, texts)
        # the native tokenizer + vectorized encoding covers the exploded
        # sentence set in one pass, as the document-level builds do
        if fast is None:
            from tdr_torch.text.fast import fast_available

            fast = preprocessor is None and fast_available()
        if fast:
            from tdr_torch.text.fast import fast_encode_corpus

            vocab, *coo = fast_encode_corpus(
                stexts, [lang] * len(stexts), min_df=index_cfg.min_df)
            model = BM25Model.from_coo(vocab, tuple(coo), sids, lang=lang,
                                       bm25=bm25, index_cfg=index_cfg,
                                       device=device)
            return cls(model, stexts)
        pp = preprocessor or Preprocessor("best")
        toks = [pp(s, lang) for s in stexts]
        return cls(BM25Model.build(toks, sids, lang=lang, bm25=bm25,
                                   index_cfg=index_cfg, device=device), stexts)

    def top_sentences(
        self, query_tokens: Sequence[Sequence[str]], k: int = 100
    ) -> Tuple[np.ndarray, List[List[str]]]:
        vals, rows = self.model.topk_tokens(query_tokens, k)
        sids = [[self.model.docids[r] for r, v in zip(qr, qv) if np.isfinite(v)]
                for qr, qv in zip(rows, vals)]
        return vals, sids


def candidate_union(
    model: BM25Model,
    qids: np.ndarray,           # (Q, T) encoded query term ids
    qw: np.ndarray,             # (Q, T) weights (0 = padding)
    max_candidates: int = 1000,
) -> np.ndarray:
    """Boolean union of postings per query, capped (team_run1.py:152-169).

    Returns (Q, max_candidates) int32 local rows, padded with -1.  Order
    follows the reference: postings walked term by term, first-seen kept.
    The index arrays come to the host once per call.
    """
    indptr = model.index.indptr.cpu().numpy().astype(np.int64)
    docs = model.index.postings_doc.cpu().numpy()
    df = model.index.stats.df.cpu().numpy().astype(np.int64)
    Q, T = qids.shape
    out = np.full((Q, max_candidates), -1, np.int32)
    # generation-stamped "seen" array: one allocation for the whole batch,
    # no per-posting python loop
    n_rows = int(docs.max()) + 1 if docs.size else 1
    seen = np.full(n_rows, -1, np.int64)
    for q in range(Q):
        count = 0
        for t in range(T):
            if qw[q, t] <= 0 or count >= max_candidates:
                continue
            term = int(qids[q, t])
            seg = docs[indptr[term]: indptr[term] + df[term]]
            new = seg[seen[seg] != q]
            if new.size == 0:
                continue
            # first occurrence order within the segment
            _, first = np.unique(new, return_index=True)
            new = new[np.sort(first)][: max_candidates - count]
            out[q, count: count + new.size] = new
            seen[new] = q
            count += new.size
    return out


def _minmax(x: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Per-row min-max over the valid entries → [0, 1]; invalid slots → 0.

    Rows with no spread (or no valid entries) map to 0.5 so a constant
    signal neither dominates nor cancels the other signal in a fusion sum.
    Monotonic per row, so fusing with α∈{0,1} reproduces the input order.
    """
    lo = np.min(np.where(valid, x, np.inf), axis=1, keepdims=True)
    hi = np.max(np.where(valid, x, -np.inf), axis=1, keepdims=True)
    span = hi - lo
    ok = span > 0
    with np.errstate(invalid="ignore"):
        scaled = (x - lo) / np.where(ok, span, 1.0)
    out = np.where(ok, scaled, 0.5)
    return np.where(valid, out, 0.0)


@dataclass
class SentenceLmCascade:
    """Sentence-BM25 top-M → dense-encoder re-rank → doc dedupe top-k.

    Mirrors team_run1.py:173-295: BM25 over sentences (top 100), mean-pooled
    transformer embeddings for candidate sentences + query, cosine ranking,
    sentence→doc dedupe to the final top-k.  ``dense`` is a ``DenseModel``
    (its encoder a ``DualEncoder`` or a ``BertEncoder``) on the device of
    the sentence indexes.
    """

    sentence_models: Dict[str, SentenceBM25]
    dense: object                       # tdr_torch.models.dense.DenseModel
    bm25_candidates: int = 100
    preprocessor: Preprocessor = field(default_factory=lambda: Preprocessor("best"))
    default_lang: str = "en"
    query_batch: int = 128
    # Hybrid re-rank: final = α·minmax(bm25) + (1−α)·minmax(cosine), both
    # normalized per query over the candidate set.  α=0 is the reference's
    # pure-LM re-rank (team_run1.py:274-295 ranks candidates by embedding
    # similarity alone) — the right choice for a strong pretrained encoder;
    # the default keeps stage-1 evidence in the mix for a weak one.
    fusion_alpha: float = 0.5
    # Doc-level evidence aggregation: the fused sentence score gains
    # doc_agg_weight · minmax(per-doc sum of the fused scores over the doc's
    # candidate sentences) — a document whose many sentences reach the
    # candidate set is likelier relevant than one matched by a single
    # sentence.  0 disables (the reference's first-occurrence dedupe).
    doc_agg_weight: float = 0.4

    def _tokenize(self, queries: Sequence[str], q_idx: Sequence[int],
                  lang: str) -> List[List[str]]:
        if self.preprocessor.spec.name == "best":
            from tdr_torch.text.fast import fast_available, fast_tokenize_texts

            if fast_available():
                return fast_tokenize_texts([queries[i] for i in q_idx], lang)
        return [self.preprocessor(queries[i], lang) for i in q_idx]

    def _run_stages(self, queries: Sequence[str], langs: Sequence[str]):
        """Stage 1 (sentence-BM25 top-M) + stage-2 signals, NO fusion.

        Returns chunks of ``(smodel, sel, vals, valid, sims, doc_idx)`` so
        fusion/dedupe can re-run per ``alpha`` without re-scoring (the alpha
        tuner sweeps a grid over ONE pass of the expensive stages).

        Every language group is cut into fixed ``query_batch`` chunks; each
        chunk's stage 1 and its candidates' cosine similarities are queued
        on the device, and all chunks come back in ONE device→host copy."""
        from tdr_torch.rank.router import _gather_results

        groups: Dict[str, List[int]] = {}
        for i, lang in enumerate(langs):
            key = lang if lang in self.sentence_models else self.default_lang
            groups.setdefault(key, []).append(i)

        pending = []        # (smodel, sel, vals, rows, sims, n) per chunk
        for lang, q_idx in groups.items():
            smodel = self.sentence_models[lang]
            # corpus-wide sentence embeddings, computed ONCE (reference
            # semantics, team_run1.py:225-239)
            smodel.precompute_embeddings(self.dense)
            toks = self._tokenize(queries, q_idx, lang)
            q_embs = self.dense.encode_queries([queries[i] for i in q_idx])
            n_rows = len(smodel.texts)
            for s in range(0, len(q_idx), self.query_batch):
                vals, rows, n = smodel.model.topk_tokens_async(
                    toks[s : s + self.query_batch], self.bm25_candidates,
                    pad_to=self.query_batch)
                # (n, M, D) candidate embeddings against each query's
                rows_c = rows[:n].long().clamp(0, n_rows - 1)
                with ieee_f32():
                    sims = torch.bmm(smodel.embeddings[rows_c],
                                     q_embs[s : s + n, :, None])[..., 0]
                pending.append((smodel, q_idx[s : s + self.query_batch],
                                vals, rows, sims, n))

        if not pending:
            return []

        # ONE packed pull: scores, rows and similarities of every chunk
        all_vals, all_rows, all_sims = _gather_results(
            [p[2] for p in pending], [p[3] for p in pending],
            [p[4] for p in pending])

        chunks = []
        for b, (smodel, sel, vals_dev, _, _, n) in enumerate(pending):
            M = vals_dev.shape[1]
            vals = all_vals[b][:n, :M]
            rows = all_rows[b][:n, :M]
            sims = all_sims[b][:n, :M]
            valid = np.isfinite(vals)                            # (n, M)
            rows_c = np.clip(rows, 0, len(smodel.texts) - 1)
            doc_idx = smodel.doc_of_row[rows_c]                  # (n, M)
            chunks.append((smodel, sel, vals, valid, sims, doc_idx))
        return chunks

    @staticmethod
    def _doc_evidence(base: np.ndarray, valid: np.ndarray,
                      doc_idx: np.ndarray) -> np.ndarray:
        """Per-candidate doc evidence: the sum of ``base`` over ALL valid
        candidate sentences belonging to the same document, per query row
        (vectorized via row-offset doc ids + one np.add.at)."""
        n, M = base.shape
        if base.size == 0:
            return np.zeros_like(base)
        stride = int(doc_idx.max()) + 1
        gid = np.where(valid,
                       doc_idx.astype(np.int64)
                       + stride * np.arange(n, dtype=np.int64)[:, None],
                       np.int64(-1))
        flat = gid.ravel()
        contrib = np.where(valid, base, 0.0).ravel()
        uniq, inv = np.unique(flat, return_inverse=True)
        sums = np.zeros(uniq.size, base.dtype)
        np.add.at(sums, inv, contrib)
        out = sums[inv].reshape(n, M)
        return np.where(valid, out, 0.0)

    @classmethod
    def _fuse(cls, vals, valid, sims, alpha: float,
              doc_agg: float = 0.0, doc_idx=None) -> np.ndarray:
        """α·minmax(bm25) + (1−α)·minmax(cosine) [+ doc evidence],
        invalid → −inf."""
        if alpha > 0.0:
            # per-query min-max over the valid candidates puts both
            # signals on [0, 1]; normalization is monotonic, so α=1
            # reproduces the BM25 order and α=0 the cosine order
            fused = (alpha * _minmax(vals, valid)
                     + (1.0 - alpha) * _minmax(sims, valid))
        else:
            fused = sims
        if doc_agg > 0.0 and doc_idx is not None:
            ev = cls._doc_evidence(np.where(valid, fused, 0.0), valid,
                                   doc_idx)
            fused = fused + doc_agg * _minmax(ev, valid)
        return np.where(valid, fused, -np.inf)

    @staticmethod
    def _dedupe(smodel, order_row, valid_row, doc_idx_row, k) -> List[str]:
        """Sentences → docs in ``order_row``, keep first (best) per doc."""
        docs: List[str] = []
        seen = set()
        for o in order_row:
            if not valid_row[o]:
                break
            d = int(doc_idx_row[o])
            if d not in seen:
                seen.add(d)
                docs.append(smodel.doc_table[d])
            if k is not None and len(docs) >= k:
                break
        return docs

    def retrieve(
        self, queries: Sequence[str], langs: Sequence[str], k: int = 10,
        with_stage1: bool = False,
    ):
        """Top-k docids per query; ``with_stage1=True`` additionally returns
        the FULL deduped candidate-doc lists in BM25 order (the stage-1
        ranking before the dense re-rank) so callers can measure the
        re-rank's candidate ceiling and its win/loss vs plain sentence-BM25."""
        chunks = self._run_stages(queries, langs)
        if not chunks:
            return ([], []) if with_stage1 else []
        results: List[Optional[List[str]]] = [None] * len(queries)
        stage1: List[Optional[List[str]]] = [None] * len(queries)
        for smodel, sel, vals, valid, sims, doc_idx in chunks:
            fused = self._fuse(vals, valid, sims, self.fusion_alpha,
                               self.doc_agg_weight, doc_idx)
            order = np.argsort(-fused, axis=1, kind="stable")    # (n, M)
            for j, qi in enumerate(sel):
                results[qi] = self._dedupe(smodel, order[j], valid[j],
                                           doc_idx[j], k)
                if with_stage1:
                    # same dedupe in stage-1 (BM25) order, NO k cap: the
                    # full candidate-doc list bounds any re-ranker's recall
                    stage1[qi] = self._dedupe(
                        smodel, range(valid.shape[1]), valid[j],
                        doc_idx[j], None)
        out = [r if r is not None else [] for r in results]
        if with_stage1:
            return out, [r if r is not None else [] for r in stage1]
        return out

    def tune_fusion_alpha(
        self, queries: Sequence[str], langs: Sequence[str],
        positives: Sequence[str], k: int = 10,
        grid: Sequence[float] = (0.0, 0.2, 0.35, 0.5, 0.65, 0.8, 1.0),
        agg_grid: Sequence[float] = (0.0, 0.2, 0.4, 0.8),
    ) -> Tuple[float, Dict[Tuple[float, float], float]]:
        """Pick ``fusion_alpha`` AND ``doc_agg_weight`` by recall@k on a
        DEV split (2-D grid).

        The expensive stages (sentence-BM25 top-M + encoder forwards) run
        once; each grid point only re-fuses and re-dedupes on the host.
        Sets both fields to the best values and returns the best alpha with
        the full ``{(alpha, agg): recall}`` curve.  Use held-out queries,
        not the eval set.
        """
        from tdr_torch.eval.metrics import recall_at_k

        chunks = self._run_stages(queries, langs)
        curve: Dict[Tuple[float, float], float] = {}
        for alpha in grid:
            for agg in agg_grid:
                results: List[List[str]] = [[] for _ in queries]
                for smodel, sel, vals, valid, sims, doc_idx in chunks:
                    fused = self._fuse(vals, valid, sims, alpha, agg, doc_idx)
                    order = np.argsort(-fused, axis=1, kind="stable")
                    for j, qi in enumerate(sel):
                        results[qi] = self._dedupe(smodel, order[j], valid[j],
                                                   doc_idx[j], k)
                curve[(alpha, agg)] = recall_at_k(results, positives, k)
        best = max(curve, key=lambda a: (curve[a], a))
        self.fusion_alpha = float(best[0])
        self.doc_agg_weight = float(best[1])
        return float(best[0]), curve
