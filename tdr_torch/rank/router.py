"""Retrieval orchestration for the port: per-language model routing and
query batching (``tdr/rank/router.py``).

Seven independent per-language BM25 models with docid maps; queries are
grouped by language, tokenized, padded to a bucketed batch size (1, 8,
then ``query_batch``) and scored on the models' device.  Every batch is
dispatched before any result is read; the results then come back in ONE
device→host copy per ``retrieve``.  The host also waits on the device
inside each batch: the query tensors' two host→device copies and the
overflow flag's read (``tdr_torch.sync.*`` spans name each wait while a
profiler records).
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from tdr_torch.data.loaders import Corpus
from tdr_torch.index.build import full_head_bytes
from tdr_torch.models.sparse import BM25Model, SparseModel
from tdr_torch.text.preprocess import Preprocessor
from tdr_torch.text.vocab import build_vocab, encode_docs
from tdr_torch.utils.config import BM25Config, IndexConfig
from tdr_torch.utils.device import DeviceLike, resolve_device
from tdr_torch.utils.trace import Tracer, annotate, count, log


def build_language_models(
    corpus: Corpus,
    model_cls: Type[SparseModel] = BM25Model,
    preprocessor: Optional[Preprocessor] = None,
    bm25: BM25Config = BM25Config(),
    index_cfg: IndexConfig = IndexConfig(),
    max_query_terms: int = 64,
    head_size: Optional[int] = None,
    tracer: Optional[Tracer] = None,
    use_native: bool = True,
    resume_dir: Optional[str] = None,
    device: DeviceLike = None,
) -> Dict[str, SparseModel]:
    """Partition the corpus by language, preprocess, and build one model per
    language on ``device``, the total head budget waterfilled across them.

    ``use_native=True`` encodes through the C++ tokenizer
    (``tdr_torch.text.fast``) when it builds and the preprocessor is the
    default "best" pipeline; otherwise the Python path runs.

    ``resume_dir`` makes the build resumable: each finished language model
    is checkpointed there (``tdr``'s sparse checkpoint format), and
    languages already complete there are loaded instead of rebuilt, their
    heads charged against the budget first."""
    from tdr_torch.ckpt import load_sparse_model, save_sparse_model

    dev = resolve_device(device)
    pp = preprocessor or Preprocessor("best")
    tracer = tracer or Tracer("build_language_models")
    by_lang: Dict[str, List[int]] = {}
    for i, lang in enumerate(corpus.langs):
        by_lang.setdefault(lang, []).append(i)

    fast = False
    if use_native and preprocessor is None:
        from tdr_torch.text.fast import fast_available

        fast = fast_available()

    def _encode_one(lang, rows):
        docids = [corpus.docids[i] for i in rows]
        if fast:
            from tdr_torch.text.fast import fast_encode_corpus

            texts = [corpus.texts[i] for i in rows]
            vocab, *coo = fast_encode_corpus(
                texts, [lang] * len(rows), min_df=index_cfg.min_df)
            coo = tuple(coo)
        else:
            toks = [pp(corpus.texts[i], lang) for i in rows]
            vocab = build_vocab(toks, min_df=index_cfg.min_df)
            coo = encode_docs(toks, vocab)
        return lang, (vocab, coo, docids, len(rows))

    models: Dict[str, SparseModel] = {}
    to_encode = []
    for lang, rows in sorted(by_lang.items()):
        lang_dir = os.path.join(resume_dir, lang) if resume_dir else None
        if lang_dir and os.path.exists(os.path.join(lang_dir, "meta.json")):
            models[lang] = load_sparse_model(lang_dir, dev)
            log.info("resumed '%s' model from %s", lang, lang_dir)
        else:
            to_encode.append((lang, rows))

    # languages encode concurrently: the C++ tokenizer releases the GIL
    encoded: Dict[str, tuple] = {}
    if to_encode:
        with tracer.span("encode:all", n_langs=len(to_encode)):
            with ThreadPoolExecutor(max_workers=min(8, len(to_encode))) as ex:
                for lang, payload in ex.map(lambda a: _encode_one(*a),
                                            to_encode):
                    encoded[lang] = payload

    stats = {lang: (full_head_bytes(vocab.size, n, index_cfg), float(n))
             for lang, (vocab, _, _, n) in encoded.items()}
    # resumed heads already occupy the device: charge them first
    resumed_bytes = sum(m.index.head_rows.numel()
                        * m.index.head_rows.element_size()
                        for m in models.values())
    allocs = _waterfill_head_budget(
        max(index_cfg.head_budget_bytes - resumed_bytes, 0), stats)

    for lang, (vocab, coo, docids, n) in encoded.items():
        lang_cfg = dataclasses.replace(index_cfg, head_budget_bytes=allocs[lang])
        with tracer.span(f"build:{lang}", n_docs=n):
            kwargs = dict(lang=lang, index_cfg=lang_cfg,
                          max_query_terms=max_query_terms, head_size=head_size,
                          device=dev)
            if model_cls is BM25Model:
                kwargs["bm25"] = bm25
            models[lang] = model_cls.from_coo(vocab, coo, docids, **kwargs)
        log.info("built %s model for '%s': %d docs, vocab %d, head %d, tail_pmax %d",
                 model_cls.__name__, lang, n, models[lang].vocab.size,
                 models[lang].index.head_size, models[lang].index.tail_pmax)
        if resume_dir is not None:
            save_sparse_model(os.path.join(resume_dir, lang), models[lang])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return models


# Copied from tdr/rank/router.py (verbatim).
def _waterfill_head_budget(
    total_bytes: int, stats: Dict[str, Tuple[int, float]],
    floor_bytes: int = 64 << 20,
) -> Dict[str, int]:
    """Split ``total_bytes`` of head budget: every language first gets
    ``min(need, floor_bytes)`` (floors scale down together if even they
    exceed the budget), then the remainder is waterfilled — shares
    proportional to weight (doc count), capped at each language's ``need``
    (full-vocab coverage), surplus re-poured over the still-hungry
    languages until spent.

    CONSERVES the budget: ``sum(allocs) <= total_bytes`` always (the
    pre-fix applied the floor AFTER allocation, so many small languages
    could overcommit HBM by up to n_langs * floor — the hole the split
    exists to close).

    ``stats``: {lang: (need_bytes, weight)} → {lang: alloc_bytes}."""
    budget = int(total_bytes)
    # phase 0: reserve the floors out of the total (a floor never exceeds
    # what the language can use)
    base = {lang: min(need, floor_bytes) for lang, (need, _) in stats.items()}
    base_sum = sum(base.values())
    if budget <= 0:
        return {lang: 0 for lang in stats}
    if base_sum > budget:
        scale = budget / base_sum
        return {lang: int(b * scale) for lang, b in base.items()}
    budget -= base_sum
    alloc = dict(base)
    hungry = {lang: (need - base[lang], w)
              for lang, (need, w) in stats.items() if need > base[lang]}
    while hungry and budget > 0:
        wsum = sum(w for _, w in hungry.values())
        if wsum <= 0:
            break
        saturated = {
            lang: need for lang, (need, w) in hungry.items()
            if need <= int(budget * w / wsum)
        }
        if not saturated:
            for lang, (_, w) in hungry.items():
                alloc[lang] += int(budget * w / wsum)
            break
        for lang, need in saturated.items():
            alloc[lang] += need
            budget -= need
            del hungry[lang]
    return alloc


def _gather_results(vals_list: List[torch.Tensor], rows_list: List[torch.Tensor],
                    extra_list: Optional[List[torch.Tensor]] = None) -> tuple:
    """Stack the per-batch (B, k) results on the device and bring them to
    the host in ONE copy: scores travel as their int32 bit patterns beside
    the int32 rows, so one tensor holds both.  Batches of other shapes are
    padded on the device to the largest (scores with -inf, rows with 0);
    callers slice each back to its own rows and width.  ``extra_list``,
    float blocks of the same batches and no larger (the sentence cascade's
    similarities), comes back in the same copy as a third array."""
    b = max(v.shape[0] for v in vals_list)
    w = max(v.shape[1] for v in vals_list)
    pad = torch.nn.functional.pad

    def floats(blocks):
        return torch.stack([pad(v.float(), (0, w - v.shape[1], 0, b - v.shape[0]),
                                value=float("-inf")) for v in blocks]
                           ).view(torch.int32)

    rows = [pad(r.to(torch.int32), (0, w - r.shape[1], 0, b - r.shape[0]))
            for r in rows_list]
    slabs = [floats(vals_list), torch.stack(rows)]
    if extra_list is not None:
        slabs.append(floats(extra_list))
    stacked = torch.stack(slabs)
    with annotate("tdr_torch.sync.results"):
        host = stacked.cpu().numpy()
    out = (host[0].view(np.float32), host[1])
    return out if extra_list is None else out + (host[2].view(np.float32),)


@dataclass
class LanguageRouter:
    """Routes queries to per-language models and merges results in input
    order."""

    models: Dict[str, SparseModel]
    preprocessor: Preprocessor = field(default_factory=lambda: Preprocessor("best"))
    query_batch: int = 128
    default_lang: str = "en"
    detect_missing_lang: bool = True
    use_native: bool = True            # C++ tokenizer for query preprocessing
    # small-batch buckets: a chunk pads to the smallest bucket that fits,
    # then to query_batch; () pads every chunk to query_batch
    query_buckets: Tuple[int, ...] = (1, 8)

    def _tokenize(self, queries: Sequence[str], q_idx: Sequence[int],
                  lang: str) -> List[List[str]]:
        with annotate("tdr_torch.router.tokenize"):
            if self.use_native and self.preprocessor.spec.name == "best":
                from tdr_torch.text.fast import fast_available

                if fast_available():
                    from tdr_torch.text.fast import fast_tokenize_texts

                    return fast_tokenize_texts([queries[i] for i in q_idx],
                                               lang)
            return [self.preprocessor(queries[i], lang) for i in q_idx]

    def _group(self, langs: Optional[Sequence[str]],
               queries: Sequence[str]) -> Dict[str, List[int]]:
        groups: Dict[str, List[int]] = {}
        with annotate("tdr_torch.router.group"):
            for i in range(len(queries)):
                lang = langs[i] if langs is not None else None
                if lang is None or lang == "" or lang not in self.models:
                    if self.detect_missing_lang:
                        from tdr_torch.text.langid import detect_language

                        lang = detect_language(queries[i],
                                               default=self.default_lang)
                    if lang not in self.models:
                        lang = self.default_lang
                groups.setdefault(lang, []).append(i)
        return groups

    def _pad_target(self, n: int) -> int:
        """Smallest bucket that fits ``n``, else the full batch."""
        for b in sorted(self.query_buckets):
            if n <= b < self.query_batch:
                return b
        return self.query_batch

    def _batches_resolved(self, queries, langs, k):
        """Dispatch every batch, then resolve all of them with one
        device→host copy: [(model, sel, vals (n, k), rows (n, k))].  A
        model without ``topk_tokens_async`` (the segment store) resolves
        its batch itself."""
        pending, resolved = [], []
        for lang, q_idx in self._group(langs, queries).items():
            model = self.models[lang]
            toks = self._tokenize(queries, q_idx, lang)
            for s in range(0, len(q_idx), self.query_batch):
                chunk = toks[s:s + self.query_batch]
                sel = q_idx[s:s + self.query_batch]
                pad_to = self._pad_target(len(chunk))
                count("router.rows_real", len(chunk))
                count("router.rows_padded", pad_to)
                if hasattr(model, "topk_tokens_async"):
                    vals, rows, n = model.topk_tokens_async(chunk, k,
                                                            pad_to=pad_to)
                    pending.append((model, sel, vals, rows, n))
                else:
                    vals, rows = model.topk_tokens(chunk, k, pad_to=pad_to)
                    resolved.append((model, sel, vals, rows))
        if pending:
            vals_all, rows_all = _gather_results([p[2] for p in pending],
                                                 [p[3] for p in pending])
            for i, (model, sel, vals, _, n) in enumerate(pending):
                w = vals.shape[1]
                resolved.append((model, sel, vals_all[i][:n, :w],
                                 rows_all[i][:n, :w]))
        return resolved

    @staticmethod
    def _map_docids(model, vals: np.ndarray, rows: np.ndarray) -> List[List[str]]:
        """(n, k) rows → docid lists via one object-array gather; -inf pad
        entries are dropped."""
        with annotate("tdr_torch.router.map_docids"):
            arr = getattr(model, "_docid_arr", None)
            if arr is None or len(arr) != len(model.docids):
                arr = np.asarray(model.docids, dtype=object)
                model._docid_arr = arr
            names = arr[np.clip(rows, 0, len(arr) - 1)]
            finite = np.isfinite(vals)
            if bool(finite.all()):
                return [row.tolist() for row in names]
            return [names[j][finite[j]].tolist()
                    for j in range(names.shape[0])]

    def retrieve(self, queries: Sequence[str],
                 langs: Optional[Sequence[str]] = None,
                 k: int = 10) -> List[List[str]]:
        """Top-k docids per query, in input order.  ``langs=None`` (or
        unknown codes) routes by detected language."""
        with annotate("tdr_torch.router.retrieve"):
            results: List[Optional[List[str]]] = [None] * len(queries)
            for model, sel, vals, rows in self._batches_resolved(queries,
                                                                 langs, k):
                for j, docs in zip(sel, self._map_docids(model, vals, rows)):
                    results[j] = docs
            return [r if r is not None else [] for r in results]

    def retrieve_with_scores(self, queries: Sequence[str],
                             langs: Optional[Sequence[str]] = None,
                             k: int = 10) -> Tuple[List[List[str]], np.ndarray]:
        with annotate("tdr_torch.router.retrieve"):
            docid_out: List[Optional[List[str]]] = [None] * len(queries)
            score_out = np.zeros((len(queries), k), np.float32)
            for model, sel, vals, rows in self._batches_resolved(queries,
                                                                 langs, k):
                docs_rows = self._map_docids(model, vals, rows)
                for i, j in enumerate(sel):
                    docid_out[j] = docs_rows[i]
                    score_out[j] = vals[i]
            return ([r if r is not None else [] for r in docid_out],
                    score_out)
