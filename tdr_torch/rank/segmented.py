"""Live index updates, Lucene-style: the port of ``tdr/rank/segmented.py``.

* the **main segment** is the big immutable index (untouched by updates);
* added documents go to a small **delta segment**, rebuilt from all
  pending adds on each add batch against corpus-global statistics (df
  looked up by term string in the main vocab plus the delta's own, n_docs
  and avgdl over both segments), so its scores compare with the main's;
* queries score both segments and the top-k lists are merged on the host;
* deletions are positional tombstones filtered out of the merged top-k,
  with extra candidates (a margin of 64, 256 or 1024 by tombstone count)
  requested from each segment to cover them;
* ``compact_with`` folds everything into a fresh main segment.

Pseudo-relevance feedback runs at the store level: the global live top-F
feedback docs, ``prf_mine`` per segment with the global doc weights, the
mined terms pooled by term string on the host, and the pooled top-E terms
re-encoded into each segment's vocab with one shared weight vector.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Set

import numpy as np
import torch

from tdr_torch.index.build import build_index, compute_idf
from tdr_torch.models.sparse import BM25Model
from tdr_torch.rank.router import _gather_results
from tdr_torch.text.vocab import build_vocab, encode_docs
from tdr_torch.utils.config import BM25Config, IndexConfig
from tdr_torch.utils.trace import log


@dataclass
class SegmentedBM25:
    """BM25 retrieval over main + delta segments with tombstone deletes.
    Serves inside a ``LanguageRouter`` through ``topk_tokens``."""

    main: BM25Model
    lang: str = "en"
    bm25: BM25Config = field(default_factory=BM25Config)
    index_cfg: IndexConfig = field(default_factory=IndexConfig)
    delta: Optional[BM25Model] = None
    _delta_toks: List[List[str]] = field(default_factory=list)
    _delta_ids: List[str] = field(default_factory=list)
    # docids deleted and not since re-added (drives persistence)
    _deleted: Set[str] = field(default_factory=set)
    # positions in `docids` hidden from results: re-adding a docid shadows
    # its stale copy while the new copy at its fresh position stays live
    _dead_rows: Set[int] = field(default_factory=set)
    _pos: Optional[dict] = None   # docid -> [positions], built lazily
    # queries whose post-tombstone top-k may have lost live docs past the
    # candidate margin; a nonzero count says compact
    truncated_queries: int = 0
    query_batch: int = 256
    query_buckets: tuple = (1, 8)
    prf: bool = False
    prf_docs: int = 3
    prf_terms: int = 5
    prf_beta: float = 0.3
    prf_min_docs: int = 2

    def _positions(self) -> dict:
        if self._pos is None:
            pos: dict = {}
            for i, d in enumerate(self.main.docids):
                pos.setdefault(d, []).append(i)
            base = len(self.main.docids)
            for j, d in enumerate(self._delta_ids):
                pos.setdefault(d, []).append(base + j)
            self._pos = pos
        return self._pos

    @classmethod
    def build(cls, doc_token_lists: Sequence[Sequence[str]],
              docids: Sequence[str], lang: str = "en",
              bm25: BM25Config = BM25Config(),
              index_cfg: IndexConfig = IndexConfig(),
              device=None) -> "SegmentedBM25":
        main = BM25Model.build(doc_token_lists, docids, lang=lang, bm25=bm25,
                               index_cfg=index_cfg, device=device)
        return cls(main=main, lang=lang, bm25=bm25, index_cfg=index_cfg)

    # -- updates --------------------------------------------------------------

    def add_documents(self, doc_token_lists: Sequence[Sequence[str]],
                      docids: Sequence[str]) -> None:
        """Add documents; they are retrievable at once.  Re-adding a docid
        shadows every existing copy and revives a tombstoned id."""
        assert len(doc_token_lists) == len(docids)
        pos = self._positions()
        base = len(self.main.docids)
        for t, d in zip(doc_token_lists, docids):
            self._dead_rows.update(pos.get(d, ()))
            self._deleted.discard(d)
            self._delta_toks.append(list(t))
            pos.setdefault(d, []).append(base + len(self._delta_ids))
            self._delta_ids.append(d)
        self._rebuild_delta()

    def delete_documents(self, docids: Sequence[str]) -> None:
        """Tombstone documents (main or delta); unknown ids mark nothing."""
        pos = self._positions()
        for d in docids:
            self._dead_rows.update(pos.get(d, ()))
            self._deleted.add(d)

    def compact(self) -> None:
        raise NotImplementedError(
            "compact needs the main segment's token lists — call "
            "compact_with(all_token_lists, all_docids) with the full corpus")

    def compact_with(self, doc_token_lists: Sequence[Sequence[str]],
                     docids: Sequence[str]) -> None:
        """Rebuild one main segment from the given full corpus (one entry
        per live docid, the latest text); deleted ids are dropped."""
        keep = [i for i, d in enumerate(docids) if d not in self._deleted]
        self.main = BM25Model.build(
            [doc_token_lists[i] for i in keep], [docids[i] for i in keep],
            lang=self.lang, bm25=self.bm25, index_cfg=self.index_cfg,
            device=self.main.device)
        self.delta = None
        self._delta_toks, self._delta_ids = [], []
        self._deleted = set()
        self._dead_rows = set()
        self._pos = None
        self.truncated_queries = 0

    def _rebuild_delta(self) -> None:
        vocab = build_vocab(self._delta_toks)
        if vocab.size == 0:
            # every pending doc tokenized to nothing: a one-term vocab no
            # query can produce keeps the docs in place by position
            vocab = build_vocab([["\x00empty"]])
        coo = encode_docs(self._delta_toks, vocab)
        main_vocab = self.main.vocab
        main_df = np.asarray(main_vocab.df)
        df_delta = np.asarray(vocab.df, np.float64).copy()
        for term, i in vocab.term_to_id.items():
            j = main_vocab.term_to_id.get(term)
            if j is not None and j < main_df.shape[0]:
                df_delta[i] += float(main_df[j])
        n_total = self.main.index.n_docs + len(self._delta_ids)
        idf = compute_idf(df_delta.astype(np.float32), n_total,
                          self.bm25.idf_variant, device=self.main.device)
        main_dl = self.main.index.stats.doc_len.cpu().numpy()
        avgdl = float((main_dl.sum() + coo[3].sum()) / max(n_total, 1))
        index = build_index(*coo, vocab.size, bm25=self.bm25,
                            index_cfg=self.index_cfg, weight_kind="bm25",
                            idf=idf, avgdl=avgdl, device=self.main.device)
        self.delta = BM25Model(vocab=vocab, index=index,
                               docids=list(self._delta_ids), lang=self.lang,
                               max_query_terms=self.main.max_query_terms,
                               query_weight="unit",
                               spell_correct=self.main.spell_correct)

    # -- retrieval -------------------------------------------------------------

    @property
    def should_compact(self) -> bool:
        """True once a query hit the margin's ceiling, the tombstones sit
        in the largest margin bucket, or the delta rivals the main."""
        return (self.truncated_queries > 0
                or len(self._dead_rows) > 192
                or len(self._delta_ids) > max(64, len(self.main.docids) // 4))

    @property
    def docids(self) -> List[str]:
        return self.main.docids + (self.delta.docids if self.delta else [])

    @property
    def n_docs(self) -> int:
        return len(self.docids) - len(self._dead_rows)

    def _pad_target(self, n: int) -> int:
        for b in sorted(self.query_buckets):
            if n <= b < self.query_batch:
                return b
        return self.query_batch

    def _prf_enabled(self) -> bool:
        # a model-level prf flag on the main segment promotes to the
        # store-level loop (the store scores through _score_encoded)
        return self.prf or bool(getattr(self.main, "prf", False))

    def _prf_params(self):
        m = self.main
        if not self.prf and getattr(m, "prf", False):
            return m.prf_docs, m.prf_terms, m.prf_beta, m.prf_min_docs
        return self.prf_docs, self.prf_terms, self.prf_beta, self.prf_min_docs

    def _k_seg(self, k: int) -> int:
        """Candidate width with the tombstone margin, over a small set of
        buckets; churn past the largest is flagged at merge time."""
        n_dead = len(self._dead_rows)
        if n_dead == 0:
            return k
        if n_dead <= 48:
            return k + 64
        if n_dead <= 192:
            return k + 256
        return k + 1024

    def _encode_chunks(self, token_lists, pad_to):
        """Router-shaped chunks, encoded per segment (numpy):
        [(n, (qids, qw) main, (qids, qw) delta | None), ...]."""
        encs = []
        qb = self.query_batch
        for s in range(0, max(len(token_lists), 1), qb):
            ch = list(token_lists[s:s + qb])
            if not ch:
                break
            pad = pad_to if pad_to is not None else self._pad_target(len(ch))
            n = len(ch)
            if n < pad:
                ch = ch + [[]] * (pad - n)
            em = self.main.encode_query_tokens_np(ch)
            ed = (self.delta.encode_query_tokens_np(ch)
                  if self.delta is not None else None)
            encs.append((n, em, ed))
        return encs

    def _on_device(self, model, enc):
        return (torch.from_numpy(enc[0]).to(model.device),
                torch.from_numpy(enc[1]).to(model.device))

    def _dispatch_pull(self, encs, k_seg: int):
        """Score every chunk on both segments (everything dispatched first)
        and bring all results back in one copy; through ``_score_encoded``,
        so a model-level prf flag never expands inside the store.  Returns
        [(n, vm, rm, vd | None, rd | None), ...] numpy."""
        vs, rs, pend = [], [], []
        for n, em, ed in encs:
            vm, rm = self.main._score_encoded(*self._on_device(self.main, em),
                                              k_seg)
            vs.append(vm)
            rs.append(rm)
            if ed is not None:
                vd, rd = self.delta._score_encoded(
                    *self._on_device(self.delta, ed), k_seg)
                vs.append(vd)
                rs.append(rd)
            pend.append(n)
        av, ar = _gather_results(vs, rs)
        out, i = [], 0
        for n in pend:
            vm, rm = av[i][:n], ar[i][:n].astype(np.int64)
            i += 1
            vd = rd = None
            if self.delta is not None:
                vd, rd = av[i][:n], ar[i][:n].astype(np.int64)
                i += 1
            out.append((n, vm, rm, vd, rd))
        return out

    def _merge_pulled(self, pulled, k: int, k_seg: int,
                      count_truncation: bool = True):
        """Host merge of the per-chunk segment results: global rows,
        tombstone filter, truncation accounting."""
        vals_p, rows_p, win_p = [], [], []
        for n, vm, rm, vd, rd in pulled:
            if vd is not None:
                vals_p.append(np.concatenate([vm, vd], axis=1))
                rows_p.append(np.concatenate(
                    [rm, rd + len(self.main.docids)], axis=1))
                # per-segment saturation, before the concatenation
                win_p.append(np.isfinite(vm).all(axis=1)
                             | np.isfinite(vd).all(axis=1))
            else:
                vals_p.append(vm)
                rows_p.append(rm)
                win_p.append(np.isfinite(vm).all(axis=1))
        vals = np.concatenate(vals_p, axis=0)
        rows = np.concatenate(rows_p, axis=0)
        win_full = np.concatenate(win_p, axis=0)
        order = np.argsort(-vals, axis=1, kind="stable")
        vals = np.take_along_axis(vals, order, axis=1)
        rows = np.take_along_axis(rows, order, axis=1)
        if self._dead_rows:
            dead = (np.isin(rows, np.fromiter(self._dead_rows, np.int64))
                    & np.isfinite(vals))
            vals = np.where(dead, -np.inf, vals)
            live = np.isfinite(vals).sum(axis=1)
            truncated = int((dead.any(axis=1)
                             & (live < min(k, max(self.n_docs, 1)))
                             & win_full).sum())
            if truncated and count_truncation:
                self.truncated_queries += truncated
                log.warning(
                    "segmented top-k: %d quer%s may have lost live docs past "
                    "the tombstone margin (k_seg=%d, %d tombstones) — "
                    "compact_with() the segment store",
                    truncated, "y" if truncated == 1 else "ies", k_seg,
                    len(self._dead_rows))
            order = np.argsort(-vals, axis=1, kind="stable")
            vals = np.take_along_axis(vals, order, axis=1)
            rows = np.take_along_axis(rows, order, axis=1)
        return vals[:, :k], rows[:, :k]

    @staticmethod
    def _id_to_term_cached(model):
        tab = getattr(model, "_id_to_term_cache", None)
        if tab is None:
            tab = model.vocab.id_to_term()
            object.__setattr__(model, "_id_to_term_cache", tab)
        return tab

    def _prf_expand_encs(self, token_lists, encs):
        """Store-level RM3: global feedback pass, per-segment mining on the
        device, term-string pooling on the host, per-segment re-encoding
        of the pooled top-E terms with one shared weight vector."""
        from tdr_torch.rank.feedback import prf_mine

        F, E, beta, min_docs = self._prf_params()
        # pass 1: the global live top-F (not counted against truncation)
        pulled = self._dispatch_pull(encs, self._k_seg(F))
        vals1, rows1 = self._merge_pulled(pulled, F, self._k_seg(F),
                                          count_truncation=False)
        finite = np.isfinite(vals1) & (vals1 > 0)
        sv = np.where(finite, vals1, 0.0)
        wd = (sv / np.maximum(sv.sum(axis=1, keepdims=True),
                              1e-9)).astype(np.float32)
        base = len(self.main.docids)
        in_delta = rows1 >= base

        # per-segment mining at min_docs=1 and a widened E (the global gate
        # and the pool run on the host); counts ride the same copy
        E_mine = max(2 * E, E + 4)
        vs, ps = [], []
        qoff = 0
        for n, em, ed in encs:
            pad = em[0].shape[0]
            sl = slice(qoff, qoff + n)
            qoff += n

            def _pad_chunk(a, fill, dev):
                out = np.full((pad, F), fill, a.dtype)
                out[:n] = a[sl]
                return torch.from_numpy(out).to(dev)

            segs = [(self.main, np.where(in_delta, 0, rows1).astype(np.int32),
                     finite & ~in_delta, em)]
            if ed is not None:
                segs.append((self.delta,
                             np.where(in_delta, rows1 - base, 0).astype(np.int32),
                             finite & in_delta, ed))
            for model, rows_s, fin_s, enc in segs:
                dev = model.device
                et, ew, ec = prf_mine(
                    model._doc_major(), model.index.vocab_size,
                    *self._on_device(model, enc), _pad_chunk(wd, 0.0, dev),
                    _pad_chunk(rows_s, 0, dev), _pad_chunk(fin_s, False, dev),
                    n_expand=E_mine, min_docs=1, count_rank_clamp=min_docs)
                vs.extend([ew, ec.float()])
                ps.extend([et, et])
        av, ar = _gather_results(vs, ps)

        # host pooling per query at the term-string level
        tables = [self._id_to_term_cached(self.main)]
        if self.delta is not None:
            tables.append(self._id_to_term_cached(self.delta))
        vocabs = [self.main.vocab] + (
            [self.delta.vocab] if self.delta is not None else [])
        n_seg = len(tables)
        Qn = vals1.shape[0]
        e_ids = [np.zeros((Qn, E), np.int32) for _ in range(n_seg)]
        e_w = [np.zeros((Qn, E), np.float32) for _ in range(n_seg)]
        item = 0
        qoff = 0
        for n, em, ed in encs:
            seg_data = []
            for s in range(n_seg):
                seg_data.append((ar[item][:n], av[item][:n],
                                 av[item + 1][:n].astype(np.int32)))
                item += 2
            for i in range(n):
                g = qoff + i
                qset = set(token_lists[g]) if g < len(token_lists) else set()
                cand: dict = {}
                for s, (et_a, ew_a, ec_a) in enumerate(seg_data):
                    tab = tables[s]
                    for j in range(E_mine):
                        w = float(ew_a[i, j])
                        if not np.isfinite(w) or w <= 0:
                            continue
                        tid = int(et_a[i, j])
                        t = tab[tid] if 0 <= tid < len(tab) else ""
                        if not t or t in qset:
                            continue
                        ent = cand.get(t)
                        if ent is None:
                            cand[t] = [w, int(ec_a[i, j])]
                        else:
                            ent[0] += w
                            ent[1] += int(ec_a[i, j])
                picked = sorted(
                    ((t, tot) for t, (tot, cnt) in cand.items()
                     if cnt >= min_docs),
                    key=lambda x: -x[1])[:E]
                if not picked:
                    continue
                mx = max(picked[0][1], 1e-9)
                qscale = max(float(em[1][i].max()), 1e-9)
                for e, (t, tot) in enumerate(picked):
                    w = beta * (tot / mx) * qscale
                    for s in range(n_seg):
                        tid = vocabs[s].encode_term(t)
                        if tid >= 0:
                            e_ids[s][g, e] = tid
                            e_w[s][g, e] = w
            qoff += n

        # expanded encodings: (Q, T+E) per segment, shared weights
        new_encs = []
        qoff = 0
        for n, em, ed in encs:
            pad = em[0].shape[0]

            def _wide(enc, s):
                ids = np.zeros((pad, E), np.int32)
                w = np.zeros((pad, E), np.float32)
                ids[:n] = e_ids[s][qoff:qoff + n]
                w[:n] = e_w[s][qoff:qoff + n]
                return (np.concatenate([enc[0], ids], axis=1),
                        np.concatenate([enc[1], w], axis=1))

            new_encs.append((n, _wide(em, 0),
                             _wide(ed, 1) if ed is not None else None))
            qoff += n
        return new_encs

    def topk_tokens(self, token_lists: Sequence[Sequence[str]], k: int = 10,
                    pad_to: Optional[int] = None):
        """Merged (scores (Q, k), rows (Q, k)) over main + delta minus
        tombstones; rows index into ``self.docids``.  One copy to the host
        per pass; PRF adds its two inherent reads (feedback merge, mined
        terms)."""
        encs = self._encode_chunks(token_lists, pad_to)
        if not encs:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int64))
        if self._prf_enabled():
            encs = self._prf_expand_encs(token_lists, encs)
        k_seg = self._k_seg(k)
        pulled = self._dispatch_pull(encs, k_seg)
        return self._merge_pulled(pulled, k, k_seg, count_truncation=True)

    def retrieve_tokens(self, token_lists: Sequence[Sequence[str]],
                        k: int = 10) -> List[List[str]]:
        vals, rows = self.topk_tokens(token_lists, k)
        ids = self.docids
        return [[ids[r] for r, v in zip(rr, vv) if np.isfinite(v)]
                for rr, vv in zip(rows, vals)]
